"""Host failover of every supervised device call of the port, under the
reference's fault plans (pint_tpu_torch.runtime.faults), on the CPU.

The port runs on ``device="cpu"``; a fault plan forces every dispatch
onto the guarded worker, so hangs, transient errors and NaN readback hit
exactly the call sites they hit in the reference (the dispatch keys are
the reference's). For each of DeviceDownhillGLSFitter, GLSFitter,
WLSFitter, WidebandDownhillFitter, StreamingGLSFitter, pta_solve, the
GWB sweep and the chain:

- a hang and a run of transient errors fail over, labelled (counted and
  warned), and the result is bitwise the host path's: the host fitter
  run directly (DeviceDownhillGLSFitter; under an open CPU breaker for
  the error plan, whose tripping routes every later solve to the
  mirrors), the numpy mirror on the CPU-built system at the final
  parameters (GLSFitter, WLSFitter, the wideband solve), the streaming
  mirror fit (StreamingGLSFitter), ``pta_solve_np``, the numpy outer
  mirror from the failed chunk on (the sweep), the fault-free CPU chain
  (the chain);
- a NaN readback behaves as in the reference: the device fit fails over
  (a non-finite step), the one-shot solves hand the NaNs back;
- the same plan on the same problem gives the reference and the port
  the same ``failovers``, ``timeouts`` and ``retries`` counts and the
  same set of ``plan.applied`` keys — except where the reference does
  not fail over: a run of transient errors at a dispatch without a
  fallback (the device fit, the GLS solve) re-raises the reference's
  TransientFault, which its call sites (catching DispatchError) let
  through; the port raises ``RetriesExhausted``, a DispatchError, and
  fails over.

The faulted key's deadline is 300 ms and its hang 2 s; every other
dispatch keeps a 60 s deadline (the reference's first calls compile, and
a real pass must never time out under a loaded test run).
"""

import copy
import warnings

import numpy as np
import pytest
import torch

import pint_tpu.runtime as rrt
from pint_tpu.gls import DeviceDownhillGLSFitter as RDeviceDownhill
from pint_tpu.gls import GLSFitter as RGLSFitter
from pint_tpu.fitter import WLSFitter as RWLSFitter
from pint_tpu.parallel.pta import pta_solve as r_pta_solve
from pint_tpu.pta import GWBLikelihood as RGWBLikelihood

from pint_tpu_torch import obs
from pint_tpu_torch.fitter import WLSFitter, _wls_solve_np
from pint_tpu_torch.gls import DeviceDownhillGLSFitter, DownhillGLSFitter, \
    GLSFitter, NonFiniteStepError, StreamingGLSFitter, \
    _gls_host_failover_solve
from pint_tpu_torch.parallel.pta import pta_solve, pta_solve_np
from pint_tpu_torch.pta import GWBLikelihood
from pint_tpu_torch.pta.gwb import _gwb_outer_np
from pint_tpu_torch.runtime import Fault, FaultPlan, breaker_for, \
    get_supervisor, reset_runtime
from pint_tpu_torch.sampling import DeviceEnsembleSampler
from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter

from test_gwb import _synthetic_problems
from test_torch_device_fit import _problem, _wideband
from test_torch_sampling_chain import posterior  # noqa: F401 (fixture)

CPU = "cpu"
HANG_S = 2.0


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    from pint_tpu import obs as robs

    monkeypatch.setenv("PINT_TPU_DISPATCH_BACKOFF_MS", "1")
    for reset in (reset_runtime, rrt.reset_runtime, obs.reset,
                  robs.reset):
        reset()
    yield
    for reset in (reset_runtime, rrt.reset_runtime, obs.reset,
                  robs.reset):
        reset()


@pytest.fixture(autouse=True)
def short_deadline(monkeypatch):
    """Deadlines: 300 ms for the dispatches a plan hangs, 60 s for the
    rest, in both packages."""
    from pint_tpu.runtime.supervisor import DispatchSupervisor as RSup

    from pint_tpu_torch.runtime.supervisor import DispatchSupervisor

    def deadline(self, key, steps, backend, depth=1):
        match, short = self._plans_match
        return short * depth if match and match in key else 60.0

    for cls in (RSup, DispatchSupervisor):
        monkeypatch.setattr(cls, "_deadline_s", deadline)
        monkeypatch.setattr(cls, "_plans_match", (None, 0.3),
                            raising=False)
    return (RSup, DispatchSupervisor)


def _plan(pkg, match, kind, short=0.3, **kw):
    from pint_tpu.runtime.supervisor import DispatchSupervisor as RSup

    from pint_tpu_torch.runtime.supervisor import DispatchSupervisor

    rt = rrt if pkg == "ref" else __import__("pint_tpu_torch.runtime",
                                             fromlist=["x"])
    if kind == "hang":
        # the short deadline only where a hang is injected: a real pass
        # abandoned on its worker would run on beside the failover
        (RSup if pkg == "ref" else DispatchSupervisor)._plans_match = \
            (match, short)
        kw.setdefault("seconds", HANG_S)
    return rt.FaultPlan([rt.Fault(match=match, kind=kind, **kw)])


def _counts(snap):
    return {k: snap[k] for k in ("failovers", "timeouts", "retries")}


def _trip_cpu_breaker():
    br = breaker_for("cpu")
    for _ in range(br.threshold):
        br.on_result(False)
    assert br.is_open


def _params(model):
    return {n: (model.get_param(n).value, model.get_param(n).uncertainty)
            for n in model.free_params}


def _run(fit_fn, plan):
    with plan.active():
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fit_fn()
    return out, [str(w.message) for w in rec]


# ----------------------------------------------------- the device fit


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_device_fit_fails_over_to_the_host_fit(kind):
    """DeviceDownhillGLSFitter under Fault(match="gls.fit"): the whole fit
    fails over to DownhillGLSFitter and equals it bit for bit."""
    _, tm, _, tt = _problem()
    host_model = copy.deepcopy(tm)
    if kind == "error":
        _trip_cpu_breaker()
    host = DownhillGLSFitter(tt, host_model)
    host_chi2 = host.fit_toas()
    reset_runtime()

    fit = DeviceDownhillGLSFitter(tt, tm)
    plan = _plan("port", "gls.fit", kind)
    chi2, msgs = _run(fit.fit_toas, plan)
    assert chi2 == host_chi2
    assert _params(tm) == _params(host_model)
    np.testing.assert_array_equal(fit.parameter_covariance_matrix,
                                  host.parameter_covariance_matrix)
    assert torch.equal(fit.noise_resids, host.noise_resids)
    assert fit.step_evals is None
    assert any("fell back to DownhillGLSFitter on cpu" in m for m in msgs)
    assert ("gls.fit_step", kind) in plan.applied
    snap = get_supervisor().snapshot()
    assert snap["failovers"] >= 1
    if kind == "hang":
        assert snap["timeouts"] == 1 and snap["abandoned_workers"] == 1
    if kind == "error":
        assert snap["retries"] == 2 and snap["transient_errors"] == 3


@pytest.mark.parametrize("kind", ["hang", "error"])
def test_device_fit_counts_match_the_reference(kind):
    rm, tm, rt, tt = _problem()
    got = {}
    for pkg, fitter in (("ref", RDeviceDownhill(rt, rm)),
                        ("port", DeviceDownhillGLSFitter(tt, tm))):
        plan = _plan(pkg, "gls.fit", kind)
        if pkg == "ref" and kind == "error":
            with pytest.raises(rrt.TransientFault):
                _run(fitter.fit_toas, plan)
            continue
        _run(fitter.fit_toas, plan)
        sup = rrt.get_supervisor() if pkg == "ref" else get_supervisor()
        got[pkg] = (_counts(sup.snapshot()), {k for k, _ in plan.applied})
    if kind == "hang":
        assert got["port"] == got["ref"]
    else:
        assert got["port"][1] == {"gls.fit_step"}


# ------------------------------------------------- the one-shot solves


def _final_mirror(fit, threshold=None):
    """The host path at the fit's final parameters: the pass built on the
    CPU and the numpy mirror."""
    M, r, nvec, F, phi, _, _ = fit._system(torch.device("cpu"))
    return _gls_host_failover_solve(M.numpy(), F.numpy(), phi.numpy(),
                                    r.numpy(), nvec.numpy(),
                                    threshold=threshold, what=fit._WHAT)


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_gls_solve_failover_is_the_mirror(kind):
    rm, tm, rt, tt = _problem()
    fit = GLSFitter(tt, tm)
    plan = _plan("port", "gls.solve", kind)
    chi2, msgs = _run(fit.fit_toas, plan)
    snap = get_supervisor().snapshot()
    if kind == "nan":
        # NaN readback is not a dispatch failure: the NaNs come back
        assert np.isnan(chi2) and snap["failovers"] == 0
    else:
        _, cov, want, _ = _final_mirror(fit)
        assert chi2 == want
        np.testing.assert_array_equal(fit.parameter_covariance_matrix, cov)
        assert snap["failovers"] == 2
    ref = RGLSFitter(rt, rm)
    rplan = _plan("ref", "gls.solve", kind)
    if kind == "error":
        with pytest.raises(rrt.TransientFault):
            _run(ref.fit_toas, rplan)
        return
    rchi2, _ = _run(ref.fit_toas, rplan)
    assert _counts(snap) == _counts(rrt.get_supervisor().snapshot())
    assert {k for k, _ in plan.applied} == {k for k, _ in rplan.applied}
    if kind != "nan":
        assert chi2 == pytest.approx(rchi2, rel=1e-9)


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_wls_solve_failover_is_the_mirror(kind):
    rm, tm, rt, tt = _problem()
    start = copy.deepcopy(tm)
    fit = WLSFitter(tt, tm)
    plan = _plan("port", "wls.solve", kind)
    _run(lambda: fit.fit_toas(maxiter=1), plan)
    snap = get_supervisor().snapshot()
    cov = fit.parameter_covariance_matrix
    if kind == "nan":
        assert np.isnan(cov).all() and snap["failovers"] == 0
    else:
        # the one solve ran at the starting parameters
        res = WLSFitter(tt, start)._residuals("cpu")
        M, _, _ = start.designmatrix(tt, incoffset=True, device="cpu")
        _, want, _ = _wls_solve_np(M.numpy(), res.time_resids.numpy(),
                                   tt.get_errors() * 1e-6)
        np.testing.assert_array_equal(cov, want)
        # and the final chi2's gls.chi2 under the tripped breaker (error)
        assert snap["failovers"] >= 1
    ref = RWLSFitter(rt, rm)
    rplan = _plan("ref", "wls.solve", kind)
    _run(lambda: ref.fit_toas(maxiter=1), rplan)
    assert _counts(snap) == _counts(rrt.get_supervisor().snapshot())
    assert {k for k, _ in plan.applied} == {k for k, _ in rplan.applied}


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_wideband_solve_failover_is_the_mirror(kind):
    _, tm, rt, _ = _problem()
    _, wt = _wideband(rt)
    fit = WidebandDownhillFitter(wt, tm)
    plan = _plan("port", "wideband.solve", kind,
                 **({"count": 2} if kind == "hang" else {}))
    chi2, msgs = _run(fit.fit_toas, plan)
    snap = get_supervisor().snapshot()
    assert ("wideband.solve", kind) in plan.applied
    if kind == "nan":
        assert snap["failovers"] == 0
        return
    assert snap["failovers"] >= 1
    # the fit's final covariance: a solve at the final parameters, on
    # the device path again once the two faults are spent (hang) or by
    # the mirror under the open breaker (error)
    if kind == "error":
        _, cov, _, _ = _final_mirror(fit)
        np.testing.assert_array_equal(fit.parameter_covariance_matrix, cov)
    assert np.isfinite(chi2) and fit.converged


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_streaming_fit_fails_over_to_the_mirror(kind):
    _, tm, _, tt = _problem()
    host_model = copy.deepcopy(tm)
    host = StreamingGLSFitter(tt, host_model, chunk=128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = host._fit_host_mirror(20, 1e-3, 1e-2, 1e-13,
                                     RuntimeError("direct"), 0.0)
    fit = StreamingGLSFitter(tt, tm, chunk=128)
    plan = _plan("port", "stream.chunk", kind)
    if kind == "nan":
        with pytest.raises(NonFiniteStepError):
            _run(fit.fit_toas, plan)
        return
    chi2, msgs = _run(fit.fit_toas, plan)
    assert chi2 == want
    assert _params(tm) == _params(host_model)
    np.testing.assert_array_equal(fit.parameter_covariance_matrix,
                                  host.parameter_covariance_matrix)
    assert any("numpy streaming mirror" in m for m in msgs)
    assert get_supervisor().snapshot()["failovers"] == 1


# ------------------------------------------------------------ the array


class _T:
    """The TOA epochs the common GWB basis reads."""

    def __init__(self, n, k):
        self.tdb_day = 55000.0 + 30.0 * np.arange(n) + k
        self.tdb_frac = (np.zeros(n), np.zeros(n))


@pytest.fixture(scope="module")
def synthetic():
    out = _synthetic_problems(np.random.default_rng(5), 3, 2, 1000.0)
    for k, pr in enumerate(out[0]):
        pr.toas = _T(pr.M.shape[0], k)
    return out


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_pta_solve_failover_is_pta_solve_np(kind, synthetic):
    st = synthetic[2]
    got, rgot = {}, {}
    plan = _plan("port", "pta.batch", kind)
    with plan.active():
        out = pta_solve(st, device=CPU)
    rplan = _plan("ref", "pta.batch", kind)
    with rplan.active():
        r_pta_solve(st)
    snap = get_supervisor().snapshot()
    if kind == "nan":
        assert all(np.isnan(o).all() for o in out)
        assert snap["failovers"] == 0
    else:
        for a, b in zip(out, pta_solve_np(st)):
            np.testing.assert_array_equal(a, b)
        assert snap["failovers"] == 1
    assert _counts(snap) == _counts(rrt.get_supervisor().snapshot())
    assert {k for k, _ in plan.applied} == {k for k, _ in rplan.applied}


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_gwb_sweep_survives_mid_sweep_death(kind, synthetic):
    """The block assembly and chunk 0 serve on the device; every later
    chunk fails (tests/test_runtime_faults.py:635's death mid-sweep).
    Every chunk completes, the failed ones by the numpy outer mirror
    from the chunk boundary, labelled host-failover."""
    probs = synthetic[0]
    la = np.linspace(-15.0, -13.5, 10)
    ga = np.full(10, 13.0 / 3.0)
    G = np.eye(3) * 0.5 + 0.5

    def like(cls, **kw):
        return cls(problems=probs, gamma_matrix=G, nfreq=2, **kw)

    clean_vals = like(GWBLikelihood, device=CPU).loglik_grid(la, ga,
                                                             chunk=4)
    reset_runtime()
    lk = like(GWBLikelihood, device=CPU)
    info = {}
    plan = _plan("port", "pta.gwb/", kind, after=1)
    with plan.active():
        vals = lk.loglik_grid(la, ga, chunk=4, info=info)
    snap = get_supervisor().snapshot()
    # errors trip the breaker at chunk 1: chunk 2 is rejected untried
    assert {k for k, _ in plan.applied} == (
        {"pta.gwb/chunk1"} if kind == "error"
        else {"pta.gwb/chunk1", "pta.gwb/chunk2"})
    np.testing.assert_array_equal(vals[:4], clean_vals[:4])
    if kind == "nan":
        assert np.isnan(vals[4:]).all() and snap["failovers"] == 0
        assert info["used_pool"] == "device"
    else:
        A, x, rdr, ld = lk.build_blocks()
        pad = np.concatenate([la, la[-1:].repeat(2)]), \
            np.concatenate([ga, ga[-1:].repeat(2)])
        want = np.concatenate([_gwb_outer_np(A, x, rdr, ld, G, lk.fcols,
                                             lk.tspan, pad[0][s:s + 4],
                                             pad[1][s:s + 4])
                               for s in (4, 8)])[:6]
        np.testing.assert_array_equal(vals[4:], want)
        np.testing.assert_allclose(vals, clean_vals, rtol=1e-9)
        assert info["used_pool"] == "host-failover"
        assert snap["failovers"] == 2
    like(RGWBLikelihood).loglik_grid(la, ga, chunk=4)   # compiles
    rrt.reset_runtime()
    rlk = like(RGWBLikelihood)
    rplan = _plan("ref", "pta.gwb/", kind, after=1)
    with rplan.active():
        rlk.loglik_grid(la, ga, chunk=4)
    assert _counts(snap) == _counts(rrt.get_supervisor().snapshot())
    assert {k for k, _ in plan.applied} == {k for k, _ in rplan.applied}


# ------------------------------------------------------------ the chain


@pytest.mark.parametrize("kind", ["hang", "error", "nan"])
def test_chain_fails_over_at_chunk_2(kind, posterior, monkeypatch):  # noqa: F811
    """Chunks of 4 steps; from chunk 2 on every chunk fails and re-runs
    on the CPU posterior from the carried state: the chain is the
    fault-free chain bit for bit. (A hang: 3 s against a 1 s deadline,
    which a real 4-step chunk stays well inside.)"""
    monkeypatch.setenv("PINT_TPU_CHAIN_CHUNK", "4")
    p0 = posterior.init_walkers(8, rng=np.random.default_rng(5))

    def chain():
        s = DeviceEnsembleSampler(8, posterior.nparams,
                                  posterior.lnpost_batch, device=CPU)
        s.run_mcmc(p0, 16, seed=3)
        return s

    clean = chain()
    reset_runtime()
    plan = _plan("port", "sampling.chain", kind, after=2, short=1.0,
                 **({"seconds": 3.0} if kind == "hang" else {}))
    with plan.active():
        s = chain()
    snap = get_supervisor().snapshot()
    assert s.dispatches == 4
    if kind == "nan":
        assert [k for k, _ in plan.applied] == ["sampling.chain"] * 2
        assert np.isnan(s.chain[8:]).all() and snap["failovers"] == 0
        return
    # a hang: chunks 2 and 3 time out; errors: chunk 2's three attempts
    # trip the breaker, and chunk 3 is rejected without a try
    assert len(plan.applied) == (2 if kind == "hang" else 3)
    np.testing.assert_array_equal(s.chain, clean.chain)
    np.testing.assert_array_equal(s.lnprob, clean.lnprob)
    assert s.naccepted == clean.naccepted
    assert snap["failovers"] == 2


def test_chain_without_a_cpu_posterior_raises_labelled():
    """A CUDA sampler given no CPU posterior has no failover: the
    DispatchError raises (here the device's breaker is open, so the
    card is never touched)."""
    from pint_tpu_torch.runtime import BackendUnavailable

    br = breaker_for("cuda:0")
    br.latch()
    s = DeviceEnsembleSampler.__new__(DeviceEnsembleSampler)
    DeviceEnsembleSampler.__init__(s, 4, 2, lambda x: x[:, 0],
                                   device=CPU)
    s.device = torch.device("cuda", 0)
    s._host_lnpost_batch = None
    with pytest.raises(BackendUnavailable):
        s.run_mcmc(np.zeros((4, 2)), 4)


def test_pipelined_device_fit_is_the_chained_fit():
    """pipeline=True issues each next call of the loop by dispatch_async
    from the device-advanced (th', tl'): the same fit, bit for bit, as
    the synchronous chain (one iteration a call, so the fit takes
    several)."""
    _, tm, _, tt = _problem()
    fits = {}
    for pipe in (False, True):
        m = copy.deepcopy(tm)
        f = DeviceDownhillGLSFitter(tt, m, pipeline=pipe)
        reset_runtime()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chi2 = f.fit_toas(steps_per_dispatch=1)
        fits[pipe] = (chi2, _params(m), f.parameter_covariance_matrix,
                      f.step_evals, get_supervisor().snapshot())
    (c0, p0, v0, e0, s0), (c1, p1, v1, e1, s1) = fits[False], fits[True]
    assert c1 == c0 and p1 == p0 and e1 == e0
    np.testing.assert_array_equal(v1, v0)
    assert s0["async_dispatches"] == 0 and s1["async_dispatches"] >= 1
    assert s1["failovers"] == s0["failovers"] == 0
