"""Host-side (numpy) double-double arithmetic — same algorithms as
``pint_tpu_torch.ops.dd`` but on plain numpy arrays.

Host x86 f64 is IEEE-correctly-rounded, so error-free transforms are exact
here unconditionally. Used by the ingestion/precompute layer (MJD string
parsing, time-scale chains) where device tensors bring nothing.

Values are (hi, lo) ndarray pairs; functions mirror the tensor module 1:1.
"""

from __future__ import annotations

import numpy as np

_SPLITTER = 134217729.0


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    p = a * b
    t = _SPLITTER * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLITTER * b
    bh = t - (t - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd(hi, lo=0.0):
    hi = np.asarray(hi, dtype=np.float64)
    lo = np.broadcast_to(np.asarray(lo, dtype=np.float64), np.broadcast(hi, lo).shape)
    hi = np.broadcast_to(hi, lo.shape)
    s, e = two_sum(hi, lo)
    return quick_two_sum(s, e)


def add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def add_f(a, b):
    s, e = two_sum(a[0], np.asarray(b, np.float64))
    return quick_two_sum(s, e + a[1])


def sub(a, b):
    return add(a, (-b[0], -b[1]))


def sub_f(a, b):
    return add_f(a, -np.asarray(b, np.float64))


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a, b):
    b = np.asarray(b, np.float64)
    p, e = two_prod(a[0], b)
    return quick_two_sum(p, e + a[1] * b)


def div(a, b):
    q1 = a[0] / b[0]
    r = sub(a, mul_f(b, q1))
    q2 = (r[0] + r[1]) / (b[0] + b[1])
    return quick_two_sum(q1, q2)


def div_f(a, b):
    return div(a, dd(b))


def neg(a):
    return (-a[0], -a[1])


def to_f64(a):
    return a[0] + a[1]


def dd_round(a):
    n = np.round(a[0])
    r = (a[0] - n) + a[1]
    bump = np.where(r > 0.5, 1.0, 0.0) + np.where(r < -0.5, -1.0, 0.0)
    return dd(n + bump)


def frac(a):
    """Signed fractional part in [-0.5, 0.5]: a - round(a)."""
    n = np.round(a[0])
    s, se = two_sum(a[0], -n)
    f, fe = two_sum(s, a[1])
    f, fe = quick_two_sum(f, fe + se)
    shift = np.where(f > 0.5, 1.0, 0.0) + np.where(f < -0.5, -1.0, 0.0)
    s2, s2e = two_sum(f, -shift)
    g, ge = two_sum(s2, fe)
    return quick_two_sum(g, ge + s2e)


def taylor_horner(dt, coeffs):
    """sum_i coeffs[i] dt^i / i! with dd accumulator; dt is a dd pair,
    coeffs are f64 scalars or dd pairs."""
    import math

    acc = dd(np.zeros_like(dt[0]))
    for i in reversed(range(len(coeffs))):
        ci = coeffs[i]
        fct = float(math.factorial(i))
        acc = mul(acc, dt)
        if isinstance(ci, tuple):
            acc = add(acc, div_f(ci, fct) if fct != 1.0 else ci)
        else:
            acc = add_f(acc, np.float64(ci) / fct)
    return acc
