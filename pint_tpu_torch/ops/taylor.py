"""Taylor-series evaluation (a port of pint_tpu/ops/taylor.py).

``taylor_horner(dt, [c0, c1, c2, ...]) = c0 + c1 dt + c2 dt^2/2! + ...``
is the spindown phase engine of the reference
(src/pint/utils.py taylor_horner; src/pint/models/spindown.py):

- ``taylor_horner``/``taylor_horner_deriv``: plain Horner in the dtype
  of ``dt`` (delays, DM, their time derivatives);
- ``dd_taylor_horner``: double-double accumulator (absolute pulse phase,
  where F0*dt is ~1e10 turns and must keep <1e-9 turn error);
- ``taylor_powdiff``: the anchored route's delta phase, a difference of
  two Taylor series applied through their small argument difference.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from pint_tpu_torch.ops.dd import DD, dd_add, dd_add_f, dd_div_f, dd_mul, \
    operand


def taylor_horner(dt: torch.Tensor, coeffs: Sequence):
    """Sum_i coeffs[i] * dt^i / i! via Horner (coeffs: floats or 0-d
    tensors)."""
    return taylor_horner_deriv(dt, coeffs, deriv_order=0)


def taylor_horner_deriv(dt: torch.Tensor, coeffs: Sequence,
                        deriv_order: int = 1):
    """deriv_order-th derivative of taylor_horner with respect to dt."""
    n = len(coeffs)
    if n <= deriv_order:
        return torch.zeros_like(dt)
    # the derivative shifts the series: sum_{i>=d} c_i dt^{i-d}/(i-d)!
    acc = torch.zeros_like(dt)
    for i in reversed(range(deriv_order, n)):
        ci = coeffs[i]
        if not torch.is_tensor(ci):
            ci = float(ci)
        acc = acc * dt + ci / math.factorial(i - deriv_order)
    return acc


def taylor_powdiff(x: torch.Tensor, dxy, coeffs: Sequence,
                   t_scale: float = 1.0):
    """Sum_i coeffs[i] (x^i - y^i)/i! with y = x - dxy, computed through
    the exact factorization x^i - y^i = dxy Sum_k x^k y^(i-1-k): the
    small difference dxy is applied, never recovered by subtracting two
    large powers, so no intermediate carries the ~1e10-turn absolute
    phase (x ~ 1e8 s, the result ~ F dxy <= O(1) turns).

    ``coeffs`` are host numbers (the anchor's reference coefficients,
    fixed at build time), so each c T^(i-1)/i! is folded in exact host
    float64. ``t_scale`` T normalizes the power sums
    (Sum (x/T)^k (y/T)^(i-1-k)) so that the float32 chain does not
    overflow at high i. The arithmetic follows the dtype of ``x``."""
    coeffs = [float(c) for c in coeffs]
    T = float(t_scale) if t_scale else 1.0
    xs = x / T
    ys = xs - dxy / T
    n = len(coeffs)
    xpow = [torch.ones_like(xs)]      # xs^0 .. xs^(n-2)
    for _ in range(max(0, n - 2)):
        xpow.append(xpow[-1] * xs)
    total = torch.zeros_like(x)
    for i in range(1, n):
        if coeffs[i] == 0.0:
            continue
        acc = torch.zeros_like(x)
        for k in range(i):  # ascending: xs^k added at step k is then
            # multiplied by ys for the remaining i-1-k steps
            acc = acc * ys + xpow[k]
        total = total + (coeffs[i] * T ** (i - 1) / math.factorial(i)) * acc
    return dxy * total


def dd_taylor_horner(dt: DD, coeffs: Sequence) -> DD:
    """Sum_i coeffs[i] * dt^i / i! with a double-double accumulator.

    ``dt`` is DD (seconds since epoch); each coefficient is a DD (F0 and
    friends keep their par-file digits) or a plain number."""
    z = torch.zeros_like(dt.hi)
    acc = DD(z, z)
    for i in reversed(range(len(coeffs))):
        ci = coeffs[i]
        fct = float(math.factorial(i))
        acc = dd_mul(acc, dt)
        if isinstance(ci, DD):
            acc = dd_add(acc, dd_div_f(ci, fct) if fct != 1.0 else ci)
        else:
            acc = dd_add_f(acc, operand(ci, dt.hi) / fct)
    return acc
