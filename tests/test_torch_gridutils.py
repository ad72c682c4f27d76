"""The port's chi2 grids (pint_tpu_torch.gridutils) against the reference
pint_tpu on the CPU, on tests/test_sampling.py's pulsar: 60 white-noise
TOAs and 50 clustered TOAs with EFAC, ECORR and 5 red-noise modes, each
fitted by the reference first, gridded over (F0, F1) within 3-4 sigma.

The grid refits every node with ``maxiter`` fit steps; the port runs the
nodes vmapped in chunks, and the chunking must change no bit. The port is
held to the reference run eagerly (``jax.disable_jit()``): the
reference's compiled grid differs from its eager one by up to ~8e-9 of
chi2 (XLA's fused CPU code rounds the delays ~1 ulp apart), the port's
from the eager one by ~1e-15."""

import copy

import jax
import numpy as np
import pytest

from pint_tpu.fitter import WLSFitter as RWLSFitter
from pint_tpu.gls import GLSFitter as RGLSFitter
from pint_tpu.gridutils import grid_chisq as r_grid_chisq
from pint_tpu.gridutils import grid_chisq_derived as r_grid_chisq_derived

from pint_tpu_torch import config
from pint_tpu_torch.gridutils import grid_chisq, grid_chisq_derived

from test_sampling import _mk
from test_torch_bayesian import port_of
from test_torch_photon import _quiet

REL = 1e-9


def _fitted(noise):
    rm, rt = _mk(ntoa=50, noise=True, seed=23) if noise else _mk()
    rm = copy.deepcopy(rm)
    fitter = (RGLSFitter if noise else RWLSFitter)(rt, rm)
    _quiet(fitter.fit_toas, maxiter=2)
    return (rm, rt) + port_of(rm, rt) + (fitter.errors,)


@pytest.fixture(scope="module", params=["white", "noisy"])
def fitted(request):
    return _fitted(request.param == "noisy")


@pytest.fixture(scope="module")
def white():
    return _fitted(False)


def _axes(rm, errors, n=5, width=3.0):
    return [rm.get_param(p).value + np.linspace(-width, width, n)
            * errors[p] for p in ("F0", "F1")]


def test_grid_chisq_matches_reference(fitted):
    """A 5 x 5 grid over +-3 sigma, maxiter=2: the port's chi2 equals the
    reference's within 1e-9 relative, and its minimum is the centre node
    (the fit, tests/test_bayesian.py:195)."""
    rm, rt, tm, tt, errors = fitted
    axes = _axes(rm, errors)
    got = grid_chisq(tm, tt, ("F0", "F1"), axes, maxiter=2)
    with jax.disable_jit():
        want = np.asarray(r_grid_chisq(rm, rt, ("F0", "F1"), axes,
                                       maxiter=2))
    assert got.shape == want.shape == (5, 5)
    np.testing.assert_allclose(got, want, rtol=REL)
    assert np.unravel_index(np.argmin(got), got.shape) == (2, 2)
    assert got[2, 2] < got[4, 2] and got[2, 2] < got[2, 4]
    # the model's parameters and free set are untouched
    assert not tm.get_param("F0").frozen and not tm.get_param("F1").frozen


def test_grid_chisq_chunking_is_exact(fitted, monkeypatch):
    """Chunks of 1, 4 and 7 nodes (config.grid_chunk patched) and the
    default (all 16 in one) give the same grid bit for bit."""
    rm, rt, tm, tt, errors = fitted
    axes = _axes(rm, errors, n=4, width=4.0)
    base = grid_chisq(tm, tt, ("F0", "F1"), axes, maxiter=1)
    for chunk in (1, 4, 7):
        monkeypatch.setattr(config, "grid_chunk", lambda n, p: chunk)
        np.testing.assert_array_equal(
            grid_chisq(tm, tt, ("F0", "F1"), axes, maxiter=1), base)


def test_grid_chisq_derived_matches_reference(white):
    """A grid over the spin period P = 1/F0 (tests/test_bayesian.py:224):
    the reference's chi2 and node values, the minimum at the fit."""
    rm, rt, tm, tt, errors = white
    f0 = rm.F0.value
    sig0 = errors["F0"]
    p0 = 1.0 / f0
    pgrid = p0 + np.linspace(-1, 1, 5) * sig0 / f0 ** 2
    got, vals = grid_chisq_derived(tm, tt, ("F0",), (lambda P: 1.0 / P,),
                                   (pgrid,), maxiter=1)
    with jax.disable_jit():
        want, rvals = r_grid_chisq_derived(rm, rt, ("F0",),
                                           (lambda P: 1.0 / P,), (pgrid,),
                                           maxiter=1)
    assert got.shape == (5,) and np.argmin(got) == 2
    np.testing.assert_array_equal(vals[0], rvals[0])
    np.testing.assert_allclose(got, np.asarray(want), rtol=REL)


def test_grid_refusals_and_chunk_size(white):
    """Mismatched arguments raise ValueError as the reference's do; the
    default chunk fits 2 GiB of (N, p) blocks: 16 nodes at the 10,000-TOA,
    39-column fit-cell grid, between 1 and 64 always."""
    _, _, tm, tt, _ = white
    with pytest.raises(ValueError):
        grid_chisq(tm, tt, ("F0", "F1"), [np.zeros(2)])
    with pytest.raises(ValueError):
        grid_chisq_derived(tm, tt, ("F0",), (), (np.zeros(2),))
    with pytest.raises(ValueError):
        grid_chisq(tm, tt, ("DM1",), [np.zeros(2)])
    assert config.grid_chunk(10_000, 39) == 16
    assert config.grid_chunk(60, 3) == 64
    assert config.grid_chunk(2_000_000, 39) == 1
