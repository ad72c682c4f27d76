"""Double-double ("dd") arithmetic on torch tensors: each value is an
unevaluated sum ``hi + lo`` of two float64 tensors (~32 significant
digits, eps ~ 2^-104).

A port of ``pint_tpu/ops/dd.py``: the same error-free transforms in the
same order, so on the CPU the results are bitwise those of the reference.

- ``DD`` is a NamedTuple of two tensors; every op is a plain eager tensor
  function. Each torch op is its own kernel, so nothing contracts a
  multiply and an add into an FMA — the Dekker split product
  (``_split``/``two_prod``) depends on that. Never route these functions
  through ``torch.compile``: its generated kernels may contract.
- IEEE f64 is correctly rounded on the CPU and on the GPU alike, so the
  same chain is exact on both.
- add/sub/mul/div, round and frac are ``torch.autograd.Function``s
  carrying the reference's custom JVP rules (plain float64 tangents), so
  ``torch.func.jacfwd`` through the phase chain gives the reference's
  design-matrix columns.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Tensor = torch.Tensor
FloatLike = Union[float, Tensor]

# Veltkamp splitting constants: 2**ceil(p/2) + 1 for a p-bit mantissa.
_SPLITTER_F64 = 134217729.0   # 2**27 + 1
_SPLITTER_F32 = 4097.0        # 2**12 + 1


class DD(NamedTuple):
    """Unevaluated sum hi + lo, |lo| <= ulp(hi)/2 after renormalization."""

    hi: Tensor
    lo: Tensor


def operand(b: FloatLike, like: Tensor) -> FloatLike:
    """``b`` as an operand of arithmetic with ``like``. A Python number
    against float64 stays a number: torch passes it to the kernel as an
    argument, with no copy and no launch (``torch.as_tensor`` would copy
    it from pageable host memory, a copy that synchronizes the stream
    and cannot be captured in a CUDA graph), and float64 arithmetic
    with it is that with a 0-d tensor, bit for bit. Anything else
    becomes a tensor of ``like``'s dtype and device."""
    if isinstance(b, Tensor) or like.dtype != torch.float64:
        return torch.as_tensor(b, dtype=like.dtype, device=like.device)
    return float(b)


def dd(hi: Tensor, lo: FloatLike = 0.0) -> DD:
    """A DD from one or two tensors of any relative magnitude
    (renormalized with a full two-sum)."""
    lo = operand(lo, hi)
    if isinstance(lo, Tensor):
        hi, lo = torch.broadcast_tensors(hi, lo)
    s = two_sum(hi, lo)
    return _quick_two_sum(s.hi, s.lo)


def dd_to_f64(a: DD) -> Tensor:
    return a.hi + a.lo


# ----------------------------------------------------------------------
# Error-free transforms
# ----------------------------------------------------------------------

def two_sum(a: Tensor, b: Tensor) -> DD:
    """Knuth two-sum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return DD(s, err)


def _quick_two_sum(a: Tensor, b: Tensor) -> DD:
    """Fast two-sum, requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return DD(s, err)


def _split(a: FloatLike):
    splitter = _SPLITTER_F32 if isinstance(a, Tensor) and \
        a.dtype == torch.float32 else _SPLITTER_F64
    t = splitter * a
    a_hi = t - (t - a)
    a_lo = a - a_hi
    return a_hi, a_lo


def two_prod(a: Tensor, b: Tensor) -> DD:
    """Dekker two-product: p + err == a * b exactly (round-to-nearest,
    no FMA contraction)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return DD(p, err)


# ----------------------------------------------------------------------
# DD arithmetic. Each public op is a torch.autograd.Function whose
# forward-mode rule (jvp) is the reference's custom JVP: the tangent is
# the plain float64 derivative of hi + lo, with a zero lo tangent, so
# torch.func.jacfwd never differentiates through the error-term algebra.
# generate_vmap_rule lets jacfwd batch the tangents.
# ----------------------------------------------------------------------

def _dd_add(a: DD, b: DD) -> DD:
    s = two_sum(a.hi, b.hi)
    e = s.lo + (a.lo + b.lo)
    return _quick_two_sum(s.hi, e)


def _dd_sub(a: DD, b: DD) -> DD:
    s = two_sum(a.hi, -b.hi)
    e = s.lo + (a.lo - b.lo)
    return _quick_two_sum(s.hi, e)


def _dd_mul(a: DD, b: DD) -> DD:
    p = two_prod(a.hi, b.hi)
    e = p.lo + (a.hi * b.lo + a.lo * b.hi)
    return _quick_two_sum(p.hi, e)


def _dd_div(a: DD, b: DD) -> DD:
    # long division with one Newton correction — standard dd recipe
    q1 = a.hi / b.hi
    p = two_prod(b.hi, q1)   # dd_mul_f(b, q1), for a number b.hi too
    r = _dd_sub(a, _quick_two_sum(p.hi, p.lo + b.lo * q1))
    q2 = (r.hi + r.lo) / (b.hi + b.lo)
    return _quick_two_sum(q1, q2)


def _tangent(t, like: Tensor) -> Tensor:
    """An input's tangent, zeros when it has none (the reference
    instantiates symbolic zeros the same way, so a -0.0 tangent plus a
    zero lo tangent gives +0.0 in both)."""
    return torch.zeros_like(like) if t is None else t


def _out(t: Tensor):
    return t, torch.zeros_like(t)


class _Binary(torch.autograd.Function):
    """(a.hi, a.lo, b.hi, b.lo) -> (hi, lo); subclasses set ``fn`` and
    ``rule(dav, dbv, av, bv)``, the float64 tangent of the value."""

    generate_vmap_rule = True

    @classmethod
    def forward(cls, ahi, alo, bhi, blo):
        r = cls.fn(DD(ahi, alo), DD(bhi, blo))
        return r.hi, r.lo

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @classmethod
    def jvp(cls, ctx, dahi, dalo, dbhi, dblo):
        ahi, alo, bhi, blo = ctx.saved_tensors
        dav = _tangent(dahi, ahi) + _tangent(dalo, alo)
        dbv = _tangent(dbhi, bhi) + _tangent(dblo, blo)
        return _out(cls.rule(dav, dbv, ahi + alo, bhi + blo))


class _Add(_Binary):
    fn = staticmethod(_dd_add)

    @staticmethod
    def rule(dav, dbv, av, bv):
        return dav + dbv


class _Sub(_Binary):
    fn = staticmethod(_dd_sub)

    @staticmethod
    def rule(dav, dbv, av, bv):
        return dav - dbv


class _Mul(_Binary):
    fn = staticmethod(_dd_mul)

    @staticmethod
    def rule(dav, dbv, av, bv):
        return dav * bv + dbv * av


class _Div(_Binary):
    fn = staticmethod(_dd_div)

    @staticmethod
    def rule(dav, dbv, av, bv):
        return (dav - dbv * (av / bv)) / bv


class _DivF(torch.autograd.Function):
    """a / b for a Python number b, with no tensor made of it: _Div's
    value and tangent (b's tangent zero), bit for bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(ahi, alo, b):
        r = _dd_div(DD(ahi, alo), DD(b, 0.0))
        return r.hi, r.lo

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0], inputs[1])
        ctx.b = inputs[2]

    @staticmethod
    def jvp(ctx, dahi, dalo, _db):
        ahi, alo = ctx.saved_tensors
        dav = _tangent(dahi, ahi) + _tangent(dalo, alo)
        return _out((dav - 0.0 * ((ahi + alo) / ctx.b)) / ctx.b)


def dd_add(a: DD, b: DD) -> DD:
    return DD(*_Add.apply(a.hi, a.lo, b.hi, b.lo))


def dd_sub(a: DD, b: DD) -> DD:
    return DD(*_Sub.apply(a.hi, a.lo, b.hi, b.lo))


def dd_mul(a: DD, b: DD) -> DD:
    return DD(*_Mul.apply(a.hi, a.lo, b.hi, b.lo))


def dd_div(a: DD, b: DD) -> DD:
    return DD(*_Div.apply(a.hi, a.lo, b.hi, b.lo))


def dd_neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def dd_abs(a: DD) -> DD:
    neg = a.hi < 0
    return DD(torch.where(neg, -a.hi, a.hi), torch.where(neg, -a.lo, a.lo))


# f64-mixed fast paths (second operand an ordinary float64)

def _like(b: FloatLike, a: DD) -> FloatLike:
    return operand(b, a.hi)


def dd_add_f(a: DD, b: FloatLike) -> DD:
    s = two_sum(a.hi, _like(b, a))
    return _quick_two_sum(s.hi, s.lo + a.lo)


def dd_sub_f(a: DD, b: FloatLike) -> DD:
    return dd_add_f(a, -_like(b, a))


def dd_mul_f(a: DD, b: FloatLike) -> DD:
    b = _like(b, a)
    p = two_prod(a.hi, b)
    return _quick_two_sum(p.hi, p.lo + a.lo * b)


def dd_div_f(a: DD, b: FloatLike) -> DD:
    b = _like(b, a)
    if not isinstance(b, Tensor):
        return DD(*_DivF.apply(a.hi, a.lo, b))
    return dd_div(a, DD(b, torch.zeros_like(b)))


# ----------------------------------------------------------------------
# Rounding / fractional part — the pulse-number primitives
# (torch.round rounds half to even, as jnp.round does)
# ----------------------------------------------------------------------

def _dd_round(a: DD) -> DD:
    n1 = torch.round(a.hi)
    s = two_sum(a.hi, -n1)
    r = (s.hi + a.lo) + s.lo
    bump = torch.round(r)
    return dd(n1, bump)


def _dd_frac(a: DD) -> DD:
    n1 = torch.round(a.hi)
    s = two_sum(a.hi, -n1)
    t = two_sum(s.hi, a.lo)
    vhi, vlo = t.hi, t.lo + s.lo
    n2 = torch.round(vhi)
    s2 = two_sum(vhi, -n2)
    f0 = two_sum(s2.hi, vlo)
    f = _quick_two_sum(f0.hi, f0.lo + s2.lo)
    # renormalize into [-0.5, 0.5]
    shift = (f.hi > 0.5).to(f.hi.dtype) - (f.hi < -0.5).to(f.hi.dtype)
    s3 = two_sum(f.hi, -shift)
    f1 = two_sum(s3.hi, f.lo)
    return _quick_two_sum(f1.hi, f1.lo + s3.lo)


class _Unary(torch.autograd.Function):
    generate_vmap_rule = True

    @classmethod
    def forward(cls, ahi, alo):
        r = cls.fn(DD(ahi, alo))
        return r.hi, r.lo

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)


class _Round(_Unary):
    fn = staticmethod(_dd_round)

    @staticmethod
    def jvp(ctx, dahi, dalo):
        ahi, _ = ctx.saved_tensors
        z = torch.zeros_like(ahi)
        return z, z


class _Frac(_Unary):
    fn = staticmethod(_dd_frac)

    @staticmethod
    def jvp(ctx, dahi, dalo):
        ahi, alo = ctx.saved_tensors
        return _out(_tangent(dahi, ahi) + _tangent(dalo, alo))


def dd_round(a: DD) -> DD:
    """Round to nearest integer, returned as DD (exact); zero tangent."""
    return DD(*_Round.apply(a.hi, a.lo))


def dd_frac(a: DD) -> DD:
    """Signed fractional part in [-0.5, 0.5]: a - round(a), exact; the
    tangent passes through (d frac/dx = 1 away from half-integers)."""
    return DD(*_Frac.apply(a.hi, a.lo))


def dd_int_frac(a: DD):
    """(integer part as DD, signed frac in [-0.5, 0.5] as DD)."""
    return dd_round(a), dd_frac(a)


def dd_where(cond: Tensor, a: DD, b: DD) -> DD:
    return DD(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


# ----------------------------------------------------------------------
# Comparisons and sums
# ----------------------------------------------------------------------

def dd_lt(a: DD, b: DD) -> Tensor:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def dd_le(a: DD, b: DD) -> Tensor:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def dd_sum(a: DD, axis=None) -> DD:
    """Sum of a DD array along ``axis`` with compensated accumulation of
    the hi chain (the two-sum error of every cumulative step); the los
    are summed plainly. The error terms are exact only where cumsum is
    the sequential recurrence, as torch's is on the CPU."""
    if axis is None:
        a = DD(a.hi.reshape(-1), a.lo.reshape(-1))
        axis = 0
    s = torch.cumsum(a.hi, dim=axis)
    n = a.hi.shape[axis]
    prev = torch.cat([torch.zeros_like(s.narrow(axis, 0, 1)),
                      s.narrow(axis, 0, n - 1)], dim=axis)
    bb = s - prev
    err = (prev - (s - bb)) + (a.hi - bb)
    hi_s = s.select(axis, n - 1)
    lo_s = torch.sum(err, dim=axis) + torch.sum(a.lo, dim=axis)
    return _quick_two_sum(hi_s, lo_s)
