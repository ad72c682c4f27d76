"""The port's double-double ops (pint_tpu_torch.ops.dd, ops.taylor,
phase.Phase) against the reference pint_tpu.ops.dd on the CPU.

The same IEEE float64 operations run in the same order in both, so the
results must be bitwise equal, on the tests/test_dd.py input ranges."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.ops.taylor import dd_taylor_horner as r_dd_taylor_horner
from pint_tpu.ops.taylor import taylor_horner as r_taylor_horner
from pint_tpu.phase import Phase as RPhase

from pint_tpu_torch.ops.taylor import dd_taylor_horner, taylor_horner
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
