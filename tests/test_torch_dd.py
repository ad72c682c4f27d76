"""The port's double-double ops (pint_tpu_torch.ops.dd, ops.taylor,
phase.Phase) against the reference pint_tpu.ops.dd on the CPU.

The same IEEE float64 operations run in the same order in both, so the
results must be bitwise equal, on the tests/test_dd.py input ranges —
values, and the tangents torch.func.jacfwd pushes through the ops'
derivative rules against jax.jacfwd through the reference's custom
JVPs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from pint_tpu.ops.taylor import dd_taylor_horner as r_dd_taylor_horner
from pint_tpu.ops.taylor import taylor_horner as r_taylor_horner
from pint_tpu.ops.taylor import taylor_horner_deriv as r_taylor_deriv
from pint_tpu.phase import Phase as RPhase

from pint_tpu_torch.ops.taylor import dd_taylor_horner, taylor_horner, \
    taylor_horner_deriv
from pint_tpu_torch.phase import Phase

# the packages re-export the function ``dd``, which shadows the module
rdd = importlib.import_module("pint_tpu.ops.dd")
tdd = importlib.import_module("pint_tpu_torch.ops.dd")


def _pair(rng, n, scale):
    hi = rng.uniform(-scale, scale, n)
    lo = hi * rng.uniform(-1e-17, 1e-17, n)
    return hi, lo


def _ref(hi, lo):
    return rdd.dd(jnp.asarray(hi), jnp.asarray(lo))


def _port(hi, lo):
    return tdd.dd(torch.as_tensor(hi, dtype=torch.float64),
                  torch.as_tensor(lo, dtype=torch.float64))


def _same(r, t):
    """Bitwise equality of a reference DD/array and a port DD/tensor."""
    if isinstance(r, rdd.DD):
        return _same(r.hi, t.hi) and _same(r.lo, t.lo)
    a = np.asarray(r)
    b = t.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("name", ["dd_add", "dd_sub", "dd_mul", "dd_div"])
def test_dd_binary_ops_bitwise(name):
    rng = np.random.default_rng(42)
    a = _pair(rng, 500, 1e9)
    b = _pair(rng, 500, 1e3)
    r = getattr(rdd, name)(_ref(*a), _ref(*b))
    t = getattr(tdd, name)(_port(*a), _port(*b))
    assert _same(r, t)


@pytest.mark.parametrize("name", ["dd_add_f", "dd_sub_f", "dd_mul_f",
                                  "dd_div_f"])
def test_dd_mixed_ops_bitwise(name):
    rng = np.random.default_rng(43)
    a = _pair(rng, 500, 1e9)
    b = rng.uniform(-1e3, 1e3, 500)
    r = getattr(rdd, name)(_ref(*a), jnp.asarray(b))
    t = getattr(tdd, name)(_port(*a), torch.as_tensor(b))
    assert _same(r, t)


@pytest.mark.parametrize("name", ["dd_add_f", "dd_sub_f", "dd_mul_f",
                                  "dd_div_f"])
def test_dd_mixed_ops_with_a_number_bitwise(name):
    """A Python number as the float64 operand (passed to the kernels as an
    argument, no tensor made of it) gives the reference's values and
    jacfwd tangents with the number as a 0-d array, bitwise."""
    rng = np.random.default_rng(48)
    a = _pair(rng, 300, 1e9)
    x0 = np.array([1.7])
    for b in (3.0, 1.0 / 3.0, -7.25e5, 86400.0):
        def f(mod, x, a, b):
            r = getattr(mod, name)(mod.dd_mul_f(a, x[0]), b)
            return r.hi + r.lo

        r = jax.jacfwd(lambda x: f(rdd, x, _ref(*a), jnp.asarray(b)))(
            jnp.asarray(x0))
        t = torch.func.jacfwd(lambda x: f(tdd, x, _port(*a), b))(
            torch.as_tensor(x0))
        assert _same(r, t), b
        assert _same(getattr(rdd, name)(_ref(*a), jnp.asarray(b)),
                     getattr(tdd, name)(_port(*a), b)), b
    # the constructor's default low word is a number too
    assert _same(rdd.dd(jnp.asarray(a[0])), tdd.dd(torch.as_tensor(a[0])))


@pytest.mark.parametrize("name", ["two_sum", "two_prod"])
def test_error_free_transforms_bitwise(name):
    rng = np.random.default_rng(44)
    a = rng.uniform(-1e9, 1e9, 500)
    b = rng.uniform(-1e3, 1e3, 500)
    r = getattr(rdd, name)(jnp.asarray(a), jnp.asarray(b))
    t = getattr(tdd, name)(torch.as_tensor(a), torch.as_tensor(b))
    assert _same(r, t)


@pytest.mark.parametrize("name", ["dd_round", "dd_frac", "dd_neg",
                                  "dd_to_f64"])
def test_dd_unary_ops_bitwise(name):
    # the tests/test_dd.py round/frac range: 1e10 turns
    rng = np.random.default_rng(45)
    x = _pair(rng, 1000, 1e10)
    # half-integers exercise the round-half-to-even and frac edges
    x = (np.concatenate([x[0], np.arange(-5.5, 6.0, 1.0)]),
         np.concatenate([x[1], np.zeros(12)]))
    assert _same(getattr(rdd, name)(_ref(*x)), getattr(tdd, name)(_port(*x)))


def test_dd_int_frac_and_where_bitwise():
    rng = np.random.default_rng(46)
    x = _pair(rng, 300, 1e10)
    rn, rf = rdd.dd_int_frac(_ref(*x))
    tn, tf = tdd.dd_int_frac(_port(*x))
    assert _same(rn, tn) and _same(rf, tf)
    cond = rng.uniform(size=300) < 0.5
    r = rdd.dd_where(jnp.asarray(cond), rn, rf)
    t = tdd.dd_where(torch.as_tensor(cond), tn, tf)
    assert _same(r, t)


def test_dd_constructor_renormalizes_bitwise():
    rng = np.random.default_rng(47)
    hi = rng.uniform(-1e5, 1e5, 200)
    lo = rng.uniform(-1e3, 1e3, 200)   # unnormalized on purpose
    assert _same(rdd.dd(jnp.asarray(hi), jnp.asarray(lo)),
                 tdd.dd(torch.as_tensor(hi), torch.as_tensor(lo)))


def test_dd_exact_cancellation():
    big = tdd.dd(torch.tensor(1.0e16, dtype=torch.float64))
    tiny = tdd.dd(torch.tensor(1e-9, dtype=torch.float64))
    r = tdd.dd_sub(tdd.dd_add(big, tiny), big)
    assert float(tdd.dd_to_f64(r)) == 1e-9


def test_taylor_bitwise():
    # spindown-like coefficients over +-7.6 yr, DD and plain coefficients
    F0, F1, F2 = 61.4854764249, -1.1813e-15, 2.75e-25
    dts = np.linspace(-2.4e8, 2.4e8, 101)
    f0 = (F0, 3.1e-15)
    r = r_dd_taylor_horner(
        rdd.dd(jnp.asarray(dts)),
        [0.0, rdd.DD(jnp.asarray(f0[0]), jnp.asarray(f0[1])), F1, F2])
    t = dd_taylor_horner(
        tdd.dd(torch.as_tensor(dts)),
        [0.0, tdd.DD(torch.tensor(f0[0], dtype=torch.float64),
                     torch.tensor(f0[1], dtype=torch.float64)), F1, F2])
    assert _same(r, t)
    assert _same(r_taylor_horner(jnp.asarray(dts), [2.0, 3.0, 4.0, F1]),
                 taylor_horner(torch.as_tensor(dts), [2.0, 3.0, 4.0, F1]))


def test_phase_int_frac_bitwise():
    rng = np.random.default_rng(48)
    x = _pair(rng, 500, 3.9e10)
    r = RPhase(_ref(*x))
    t = Phase(_port(*x))
    assert _same(r.int, t.int)
    assert _same(r.frac, t.frac)


# ---------------------------------------------------------- derivatives


def _lift(mod, x, a, b):
    """Two DD operands whose hi parts depend on x (one multiplies it, one
    divides), built from f64 products so both packages take the same
    plain-AD path into the op under test."""
    return (mod.dd_mul_f(a, x[0]), mod.dd_div(b, mod.DD(x[1], x[1] * 0)))


@pytest.mark.parametrize("name", ["dd_add", "dd_sub", "dd_mul", "dd_div",
                                  "dd_round", "dd_frac"])
def test_dd_op_tangents_bitwise(name):
    """torch.func.jacfwd through each op equals jax.jacfwd through the
    reference's custom JVP, bitwise: the tangent is the float64
    derivative of hi + lo, zero for round."""
    rng = np.random.default_rng(49)
    a, b = _pair(rng, 200, 1e9), _pair(rng, 200, 1e3)
    x0 = np.array([1.7, -2.3])

    def f(mod, x, a, b):
        p, q = _lift(mod, x, a, b)
        op = getattr(mod, name)
        r = op(p, q) if name in ("dd_add", "dd_sub", "dd_mul", "dd_div") \
            else op(mod.dd_add(p, q))
        return r.hi + r.lo

    r = jax.jacfwd(lambda x: f(rdd, x, _ref(*a), _ref(*b)))(jnp.asarray(x0))
    t = torch.func.jacfwd(lambda x: f(tdd, x, _port(*a), _port(*b)))(
        torch.as_tensor(x0))
    assert _same(r, t)
    if name == "dd_round":
        assert not t.any()


def test_dd_jvp_through_vmap_matches_loop_of_jvps():
    """jacfwd (a vmap over tangents, through generate_vmap_rule) gives
    the columns a loop of torch.func.jvp gives."""
    rng = np.random.default_rng(50)
    a = _port(*_pair(rng, 100, 1e10))

    def f(x):
        p = tdd.dd_mul(a, tdd.DD(x[0], x[0] * 0))
        q = tdd.dd_div(p, tdd.dd_add_f(tdd.DD(x[1], x[1] * 0), 3.0))
        return tdd.dd_to_f64(tdd.dd_frac(tdd.dd_sub(q, tdd.dd_round(q))))

    x = torch.tensor([1.25, 0.5], dtype=torch.float64)
    jac = torch.func.jacfwd(f)(x)
    for k in range(2):
        _, col = torch.func.jvp(f, (x,), (torch.eye(2,
                                                    dtype=torch.float64)[k],))
        assert torch.equal(jac[:, k], col)


def test_dd_abs_compare_and_sum_bitwise():
    rng = np.random.default_rng(51)
    x = _pair(rng, 400, 1e10)
    y = (x[0].copy(), x[1] + np.where(rng.uniform(size=400) < 0.5, 1e-7,
                                      -1e-7))
    assert _same(rdd.dd_abs(_ref(*x)), tdd.dd_abs(_port(*x)))
    for name in ("dd_lt", "dd_le"):
        assert _same(getattr(rdd, name)(_ref(*x), _ref(*y)),
                     getattr(tdd, name)(_port(*x), _port(*y)))



@pytest.mark.parametrize("axis", [None, 0, 1])
def test_dd_sum_is_compensated(axis):
    """dd_sum's error terms are exact only if the cumulative sum is the
    sequential recurrence, as torch's is on the CPU. XLA's CPU cumsum
    forms its partial sums in another order, so the reference's result
    is only float64-accurate: the port is held to double-double accuracy
    against the exact sum, and to the reference within float64
    rounding."""
    from fractions import Fraction

    rng = np.random.default_rng(52)
    x = _pair(rng, 400, 1e10)
    m = (x[0].reshape(20, 20), x[1].reshape(20, 20))
    t = tdd.dd_sum(_port(*m), axis=axis)
    r = rdd.dd_sum(_ref(*m), axis=axis)
    hi, lo = (np.atleast_1d(np.asarray(v)) for v in (t.hi, t.lo))
    rhi, rlo = (np.atleast_1d(np.asarray(v)) for v in (r.hi, r.lo))
    cols = [(m[0].ravel(), m[1].ravel())] if axis is None else \
        [(np.take(m[0], j, axis=1 - axis), np.take(m[1], j, axis=1 - axis))
         for j in range(20)]
    assert hi.shape == (len(cols),)
    for j, (h, low) in enumerate(cols):
        exact = sum(Fraction(float(v)) for v in np.concatenate([h, low]))
        scale = float(np.sum(np.abs(h)))
        got = Fraction(float(hi[j])) + Fraction(float(lo[j]))
        assert abs(float(got - exact)) <= 1e-28 * scale
        assert abs((hi[j] + lo[j]) - (rhi[j] + rlo[j])) <= 4e-16 * scale


@pytest.mark.parametrize("order", [0, 1, 2, 5])
def test_taylor_horner_deriv_bitwise(order):
    dts = np.linspace(-2.4e8, 2.4e8, 101)
    coeffs = [2.0, 61.4854764249, -1.1813e-15, 2.75e-25]
    assert _same(r_taylor_deriv(jnp.asarray(dts), coeffs, order),
                 taylor_horner_deriv(torch.as_tensor(dts), coeffs, order))
