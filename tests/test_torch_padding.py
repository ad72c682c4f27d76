"""TOA-axis padding of the port's fit step (``build_fit_step(pad_to=)``)
on the CPU, on tests/test_device_fitter.py's 300-TOA pulsar (EFAC, ECORR
on its epochs, 10 red-noise modes).

The padded rows repeat the last TOA, carry ``valid`` 0, nvec 1, no noise
basis and ECORR's 'no epoch' slot, so the step must land where the
unpadded step does: against the port's unpadded step, dparams within
1e-9 sigma, the covariance's diagonal within 1e-10 relative, chi2 within
1e-12 relative and the valid rows' residuals within 1e-15 s (sums over
more rows, some of them zero, reorder the float64 reductions); against
the reference's padded step (``_build_fit_core(pad_to=)``, run eagerly
with its ``_gls_core`` compiled, as tests/test_torch_device_fit.py runs
it) within the limits that file holds the unpadded step to: 1e-6 sigma
and chi2 1e-8 relative.
"""

import jax
import numpy as np
import pytest
import torch

import pint_tpu.parallel.fit_step as r_fit_step

from pint_tpu_torch.parallel import build_fit_loop, build_fit_step
from pint_tpu_torch.parallel.fit_step import _pad_leaf, _pad_to

from test_torch_device_fit import REF_FLAGS, _problem, _wideband

PAD_SIGMA, PAD_COV, PAD_CHI2, PAD_RESID = 1e-9, 1e-10, 1e-12, 1e-15
REF_SIGMA, REF_CHI2 = 1e-6, 1e-8


def _close(got, want, sigma_tol, cov_tol, chi2_tol, resid_tol, n):
    sig = np.sqrt(np.diag(want[1].numpy() if torch.is_tensor(want[1])
                          else want[1]))
    g = [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in got]
    w = [x.numpy() if torch.is_tensor(x) else np.asarray(x) for x in want]
    assert np.max(np.abs(g[0] - w[0]) / sig) <= sigma_tol
    np.testing.assert_allclose(np.diag(g[1]), np.diag(w[1]), rtol=cov_tol)
    assert float(g[2]) == pytest.approx(float(w[2]), rel=chi2_tol)
    assert np.max(np.abs(g[3][:n] - w[3][:n])) <= resid_tol


def test_pad_helpers_repeat_the_last_row():
    assert _pad_to(300, 64) == 320 and _pad_to(320, 64) == 320
    a = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(_pad_leaf(a, 2)[3:], torch.tensor([[4.0, 5.0]] * 2))
    p = torch.arange(12.0).reshape(2, 2, 3)
    out = _pad_leaf(p, 1)
    assert out.shape == (2, 3, 3) and torch.equal(out[:, 2], p[:, 1])
    one = torch.ones(1)
    assert _pad_leaf(one, 5) is one
    assert _pad_leaf(torch.tensor(2.0), 5).ndim == 0


@pytest.mark.parametrize("pad_to", [320, 384])
def test_padded_step_matches_unpadded(pad_to):
    _, tm, _, tt = _problem()
    n = tt.ntoas
    step, args, names = build_fit_step(tm, tt)
    pstep, pargs, pnames = build_fit_step(tm, tt, pad_to=pad_to)
    assert pnames == names
    valid, nvec, eid, F = pargs[9], pargs[8], pargs[10], pargs[6]
    assert valid.shape == (pad_to,) and float(valid[n:].sum()) == 0.0
    assert torch.all(nvec[n:] == 1.0) and torch.all(F[n:] == 0.0)
    assert torch.all(eid[n:] == len(pargs[11]) - 1)
    batch = pargs[4]
    # the padded TOAs repeat the last one: a real observer, not the SSB
    assert torch.equal(batch.ssb_obs_pos[n:],
                       batch.ssb_obs_pos[n - 1:n].expand(pad_to - n, 3))
    assert torch.all(batch.obs_planet_pos[:, n:] ==
                     batch.obs_planet_pos[:, n - 1:n])
    want = step(*args)
    got = pstep(*pargs)
    assert got[3].shape == (pad_to,)
    assert torch.all(torch.isfinite(got[3]))
    _close(got, want, PAD_SIGMA, PAD_COV, PAD_CHI2, PAD_RESID, n)
    assert torch.all(got[3][n:] == 0.0)   # masked rows carry no residual


def test_padded_step_matches_reference(monkeypatch):
    rm, tm, rt, tt = _problem()
    core = jax.jit(r_fit_step._gls_core, static_argnums=(8,),
                   static_argnames=("f32mm",))

    def compiled_core(*a, **kw):
        with jax.disable_jit(False):
            return core(*a, **kw)

    monkeypatch.setattr(r_fit_step, "_gls_core", compiled_core)
    rstep, _, rargs, rnames, _ = r_fit_step._build_fit_core(
        rm, rt, pad_to=384, **REF_FLAGS)
    with jax.disable_jit():
        ref = [np.asarray(x) for x in rstep(*rargs)]
    pstep, pargs, names = build_fit_step(tm, tt, pad_to=384)
    assert names == rnames
    np.testing.assert_array_equal(pargs[9].numpy(), np.asarray(rargs[9]))
    np.testing.assert_array_equal(pargs[10].numpy(), np.asarray(rargs[10]))
    got = pstep(*pargs)
    _close(got, ref, REF_SIGMA, 1e-6, REF_CHI2, 1e-12, tt.ntoas)


def test_padded_wideband_step_and_health():
    """The stacked [time; DM] step padded (the DM rows' measurements
    repeat too), and the padded step's health vector: its max residual
    in sigma over the valid rows only."""
    _, tm, rt, _ = _problem()
    _, tt = _wideband(rt)
    n = tt.ntoas
    step, args, _ = build_fit_step(tm, tt, wideband=True, health=True)
    pstep, pargs, _ = build_fit_step(tm, tt, wideband=True, pad_to=320,
                                     health=True)
    want, got = step(*args), pstep(*pargs)
    _close(got, want, PAD_SIGMA, PAD_COV, PAD_CHI2, PAD_RESID, n)
    hv, phv = want[4].numpy(), got[4].numpy()
    assert phv[0] == hv[0] == 0.0
    assert phv[1] == pytest.approx(hv[1], rel=1e-12)
    assert phv[2] == pytest.approx(hv[2], rel=PAD_CHI2)


def test_padded_loop_runs_the_same_fit():
    """``build_fit_loop(pad_to=)``: the padded loop takes the unpadded
    loop's decisions."""
    _, tm, _, tt = _problem()
    loop_fn, args, _ = build_fit_loop(tm, tt, max_iter=4)
    ploop, pargs, _ = build_fit_loop(tm, tt, max_iter=4, pad_to=320)
    out, pout = loop_fn(*args), ploop(*pargs)
    assert (out[6], out[7], out[10]) == (pout[6], pout[7], pout[10])
    assert torch.equal(out[9], pout[9])
    sig = np.sqrt(np.diag(out[3].numpy()))
    assert np.max(np.abs(pout[2].numpy() - out[2].numpy()) / sig) \
        <= PAD_SIGMA
