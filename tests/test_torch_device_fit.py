"""The device downhill fit of the port (pint_tpu_torch): ``build_fit_loop``
and ``DeviceDownhillGLSFitter`` against the reference pint_tpu on the
CPU, on tests/test_device_fitter.py's model (an isolated MSP with EFAC,
ECORR and 10 red-noise modes, F0 moved 2e-9 Hz and DM 1e-4) and its
recipe for the TOAs, at 300 TOAs.

The reference's compiled loop program rounds the marginalized chi2 at
the far-from-optimum start ~1e-6 relative away from its own compiled
step (the cancellation tests/test_device_fitter.py describes), which
moves accept decisions at the optimum. So the loop is held to the
reference's loop run eagerly (``jax.disable_jit()``), its ``_gls_core``
compiled (eagerly it takes ~10 s a call): the same iterations, decisions
and step factors, the deltas within 1e-6 sigma, chi2 within 1e-8
relative. The fitters are held to the reference's own limits
(tests/test_device_fitter.py:56-130)."""

import copy
import io
import warnings

import jax
import numpy as np
import pytest
import torch

import pint_tpu.parallel.fit_step as r_fit_step
from pint_tpu.gls import DeviceDownhillGLSFitter as RDeviceDownhill
from pint_tpu.parallel import build_fit_loop as r_build_fit_loop

import pint_tpu_torch.parallel.fit_step as port_fit_step
from pint_tpu_torch.fitter import Fitter, MaxiterReached
from pint_tpu_torch.gls import DeviceDownhillGLSFitter, DownhillGLSFitter, \
    NonFiniteStepError
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.parallel import build_fit_loop
from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter

from test_device_fitter import PAR, _two_models

CPU = "cpu"
NTOA = 300
REF_FLAGS = dict(anchored=False, jac_f32=False, matmul_f32=False)
DELTA_SIGMA, CHI2_REL = 1e-6, 1e-8   # loop against the reference


def _port_model(extra=""):
    """The port's model of ``_two_models``: the same par text and the
    same moves of F0 and DM."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(io.StringIO(PAR + extra), device=CPU)
    m.F0.value += 2e-9
    m.get_param("DM").value += 1e-4
    m.invalidate_cache(params_only=True)
    return m


_BUILT: dict = {}


def _problem(seed=2):
    """(reference model, port model, reference TOAs, port TOAs), the
    models deep copies of one built per seed."""
    if seed not in _BUILT:
        rm, _, rt = _two_models(n=NTOA, seed=seed)
        _BUILT[seed] = (rm, _port_model(), rt, toas_from_columns(rt, CPU))
    rm, tm, rt, tt = _BUILT[seed]
    return copy.deepcopy(rm), copy.deepcopy(tm), rt, tt


def _wideband(rt):
    """The TOAs with test_wideband_device_fit's DM measurements."""
    rt = copy.deepcopy(rt)
    rng = np.random.default_rng(7)
    for f in rt.flags:
        f["pp_dm"] = str(20.0 + rng.normal(0, 1e-4))
        f["pp_dme"] = "1e-4"
    return rt, toas_from_columns(rt, CPU)


def _eager_reference_loop(monkeypatch, rm, rt, max_iter, budget):
    """The reference's build_fit_loop run eagerly with its _gls_core
    compiled (module docstring)."""
    core = jax.jit(r_fit_step._gls_core, static_argnums=(8,),
                   static_argnames=("f32mm",))

    def compiled_core(*a, **kw):
        with jax.disable_jit(False):
            return core(*a, **kw)

    monkeypatch.setattr(r_fit_step, "_gls_core", compiled_core)
    loop_fn, args, names = r_build_fit_loop(rm, rt, max_iter=max_iter,
                                            **REF_FLAGS)
    with jax.disable_jit():
        out = loop_fn(*args[:-1], jax.numpy.asarray(budget, jax.numpy.int32))
    return [np.asarray(x) for x in out], names


@pytest.mark.parametrize("budget", [8, 1])
def test_fit_loop_matches_reference(monkeypatch, budget):
    """The loop at max_iter=8 with the runtime budget at 8 and at 1."""
    rm, tm, rt, tt = _problem()
    assert all(np.array_equal(a, b) for a, b in
               zip(rm._pack()[2:], tm._pack()[2:]))
    ref, rnames = _eager_reference_loop(monkeypatch, rm, rt, 8, budget)
    loop_fn, args, names = build_fit_loop(tm, tt, max_iter=8)
    assert names == rnames and args[-1] == 8
    out = loop_fn(*args[:-1], budget)
    niter, converged, nevals = out[6], out[7], out[10]
    assert (niter, converged, nevals) == (int(ref[6]), bool(ref[7]),
                                          int(ref[10]))
    assert niter <= budget
    if budget == 1:
        assert not converged
    assert np.array_equal(out[9].numpy(), ref[9])   # accepted factors
    sig = np.sqrt(np.diag(ref[3]))
    assert np.max(np.abs(out[8].numpy() - ref[8]) / sig[1:]) <= DELTA_SIGMA
    assert np.max(np.abs(out[2].numpy() - ref[2]) / sig) <= DELTA_SIGMA
    for i in (4, 5):   # best chi2, entry chi2
        assert float(out[i]) == pytest.approx(float(ref[i]), rel=CHI2_REL)


def test_fit_loop_ledger_replays_bitwise():
    """The host's dd_np replay of the loop's ledger gives the loop's own
    (th', tl') bit for bit (the loop advances by the dd mirror of
    dd_np.add)."""
    _, tm, _, tt = _problem()
    loop_fn, args, _ = build_fit_loop(tm, tt, max_iter=8,
                                      required_chi2_decrease=0.0)
    out = loop_fn(*args)
    th, tl = args[0].numpy(), args[1].numpy()
    deltas, lams = out[8].numpy(), out[9].numpy()
    assert out[6] >= 2 and np.count_nonzero(lams) >= 2
    for k in range(out[6]):
        if lams[k] > 0:
            th, tl = dd_np.add(dd_np.dd(th, tl), dd_np.dd(deltas[k]))
    assert np.array_equal(th, out[0].numpy())
    assert np.array_equal(tl, out[1].numpy())


def _close_fits(a_model, b_model, names, sigma_tol, unc_rel):
    for n in names:
        a, b = a_model.get_param(n), b_model.get_param(n)
        assert abs(a.value - b.value) <= sigma_tol * a.uncertainty, n
        if unc_rel is not None:
            assert b.uncertainty == pytest.approx(a.uncertainty,
                                                  rel=unc_rel), n


def test_matches_host_downhill():
    """tests/test_device_fitter.py:56 on the port: the device fit equals
    the port's host DownhillGLSFitter (chi2 1e-6 relative, parameters
    1e-6 sigma, uncertainties 1e-6 relative), and the reference's
    device fit to the same limits."""
    rm, tm, rt, tt = _problem()
    tm_h = copy.deepcopy(tm)
    chi2_h = DownhillGLSFitter(tt, tm_h).fit_toas()
    fit_d = DeviceDownhillGLSFitter(tt, tm)
    chi2_d = fit_d.fit_toas()
    assert fit_d.converged
    assert abs(chi2_h - chi2_d) < 1e-6 * abs(chi2_h)
    _close_fits(tm_h, tm, ("F0", "DM", "RAJ"), 1e-6, 1e-6)
    assert fit_d.step_evals >= fit_d.stats.iterations >= 1
    assert fit_d.stats.fitter == "DeviceDownhillGLSFitter"
    assert fit_d.get_noise_resids() is not None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2_r = RDeviceDownhill(rt, rm, **REF_FLAGS).fit_toas()
    assert abs(chi2_r - chi2_d) < 1e-6 * abs(chi2_r)
    _close_fits(rm, tm, tm.free_params, 1e-6, 1e-6)


def test_wideband_device_fit():
    """tests/test_device_fitter.py:82 on the port: the wideband device
    fit against the port's WidebandDownhillFitter (chi2 1e-4 relative,
    parameters 0.05 sigma), the wideband dof, the noise realization;
    and against the reference's wideband device fit to the same
    limits."""
    rm, tm, rt, tt = _problem()
    rt, tt = _wideband(rt)
    tm_h = copy.deepcopy(tm)
    chi2_h = WidebandDownhillFitter(tt, tm_h).fit_toas()
    fit_d = DeviceDownhillGLSFitter(tt, tm, wideband=True)
    chi2_d = fit_d.fit_toas()
    assert abs(chi2_h - chi2_d) < 1e-4 * abs(chi2_h)
    _close_fits(tm_h, tm, ("F0", "DM"), 0.05, None)
    assert fit_d.stats.dof == 2 * tt.ntoas - len(tm.free_params) - 1
    assert fit_d.get_noise_resids() is not None
    assert fit_d.dm_resids.resids.shape == (tt.ntoas,)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2_r = RDeviceDownhill(rt, rm, wideband=True,
                                 **REF_FLAGS).fit_toas()
    assert abs(chi2_r - chi2_d) < 1e-4 * abs(chi2_r)
    _close_fits(rm, tm, ("F0", "DM"), 0.05, None)


def test_looped_dispatch_matches_iterative():
    """tests/test_device_fitter.py:103 on the port: steps_per_dispatch=8
    and whole_fit=True land where one iteration a loop call does. The
    port chains the same eager step with the same dd advance whatever
    K is, carrying each call's last step into the next, so they agree
    bit for bit, evaluations included, within the reference's limits
    (chi2 0.5, parameters 2e-2 sigma, uncertainties 1e-6 relative)."""
    _, m1, _, tt = _problem(seed=5)
    m2, m3 = copy.deepcopy(m1), copy.deepcopy(m1)
    f1 = DeviceDownhillGLSFitter(tt, m1)
    chi2_1 = f1.fit_toas(steps_per_dispatch=1)
    f2 = DeviceDownhillGLSFitter(tt, m2)
    chi2_2 = f2.fit_toas(steps_per_dispatch=8)
    f3 = DeviceDownhillGLSFitter(tt, m3, whole_fit=True)
    chi2_3 = f3.fit_toas()
    assert abs(chi2_2 - chi2_1) < 0.5
    assert f2.converged and f3.converged
    assert f2.stats.iterations >= 1
    _close_fits(m1, m2, ("F0", "DM", "RAJ"), 2e-2, 1e-6)
    assert chi2_1 == chi2_2 == chi2_3
    assert f1.step_evals == f2.step_evals == f3.step_evals
    for n in m1.free_params:
        assert m1.get_param(n).value == m2.get_param(n).value == \
            m3.get_param(n).value, n


def test_whole_fit_budget_and_model_sync():
    """maxiter is the loop's runtime budget: the fit stops there exactly,
    raises MaxiterReached, and leaves the model at the best point found
    (the per-trial path's point after as many iterations)."""
    _, m1, _, tt = _problem()
    m2 = copy.deepcopy(m1)
    f1 = DeviceDownhillGLSFitter(tt, m1)
    with pytest.raises(MaxiterReached):
        f1.fit_toas(whole_fit=True, maxiter=2, required_chi2_decrease=0.0)
    assert f1.stats.iterations == 2
    f2 = DeviceDownhillGLSFitter(tt, m2)
    with pytest.raises(MaxiterReached):
        f2.fit_toas(maxiter=2, required_chi2_decrease=0.0)
    for n in m1.free_params:
        assert m1.get_param(n).value == m2.get_param(n).value, n


def test_nonfinite_step_falls_back_to_host_fitter(monkeypatch):
    """A non-finite first step raises NonFiniteStepError inside the fit,
    which warns and falls back to DownhillGLSFitter on the same device:
    the result is that fitter's own, bit for bit."""
    _, tm, _, tt = _problem()
    tm_h = copy.deepcopy(tm)
    real = port_fit_step.build_fit_step

    def nan_step(*a, **kw):
        step, args, names = real(*a, **kw)

        def bad(*x):
            dp, cov, chi2, r = step(*x)
            return dp * float("nan"), cov, chi2, r

        return bad, args, names

    monkeypatch.setattr(port_fit_step, "build_fit_step", nan_step)
    fit = DeviceDownhillGLSFitter(tt, tm)
    with pytest.warns(RuntimeWarning, match="fell back to DownhillGLSFitter"):
        chi2 = fit.fit_toas()
    assert fit.step_evals is None
    chi2_h = DownhillGLSFitter(tt, tm_h).fit_toas()
    assert chi2 == chi2_h
    for n in tm.free_params:
        assert tm.get_param(n).value == tm_h.get_param(n).value, n
    assert issubclass(NonFiniteStepError, ValueError)


def test_fitter_auto_device_routes():
    """Fitter.auto(device=True) gives the device fitter (narrowband and
    wideband) on the model's device; device=True with downhill=False
    raises the reference's ValueError; no device= stays with the host
    fitters."""
    _, tm, rt, tt = _problem()
    f = Fitter.auto(tt, tm)
    assert type(f) is DownhillGLSFitter
    fd = Fitter.auto(tt, tm, device=True)
    assert type(fd) is DeviceDownhillGLSFitter and not fd.wideband
    assert fd.device == torch.device(CPU)
    with pytest.raises(ValueError, match="requires downhill=True"):
        Fitter.auto(tt, tm, device=True, downhill=False)
    _, twb = _wideband(rt)
    fw = Fitter.auto(twb, tm, device=True, whole_fit=True)
    assert isinstance(fw, DeviceDownhillGLSFitter) and fw.wideband
    assert fw.whole_fit
    assert np.isfinite(fd.fit_toas())
