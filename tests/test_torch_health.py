"""The numerical-health plane of the port (pint_tpu_torch.obs.health and
the taps of the fit step, the fit loop, the GLS solve, the streaming
chunk and finalize, the device fitter and the chain) held to the
reference's pint_tpu.obs.health on the CPU.

``test_shared_semantics`` runs each case of tests/test_health.py that
does not need the serve layer through both packages (the same signal
dicts, thresholds, shadow schedules and flight dumps) and holds the
outcomes equal. The taps are held to the reference's with
``health=True`` on tests/test_device_fitter.py's 300-TOA pulsar (EFAC,
ECORR, 10 red-noise modes), the reference run eagerly
(``jax.disable_jit()``) with its ``_gls_core`` compiled, as
tests/test_torch_device_fit.py does: the non-finite counts equal, the
max |residual| in sigma within 1e-7 relative (the packages' residuals
differ by ~1e-14 s of 1 us sigmas) and chi2 within 1e-8 relative. The
solve's and the chunk's vectors, computed from the same arrays in both
packages, are held within 1e-12 (the solve's chi2, a cancelling
difference, within 1e-8). The shadow replays on the numpy mirror:
the float64 replay stays in the 1e-5 sigma band and a float32 Gram
forced into the solve leaves it.
"""

import copy
import io
import json
import time
import types
import warnings

import jax
import numpy as np
import pytest
import torch

import pint_tpu.parallel.fit_step as r_fit_step
from pint_tpu.gls import _gls_kernel as r_gls_kernel
from pint_tpu.parallel import streaming as r_stream

import pint_tpu_torch.gls as pgls
from pint_tpu_torch.gls import DeviceDownhillGLSFitter, GLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_fit_loop, build_fit_step
from pint_tpu_torch.parallel import streaming as p_stream

from test_torch_device_fit import REF_FLAGS, _problem

CPU = "cpu"
RESID_SIGMA_REL = 1e-7   # max |r|/sigma, port against the reference
CHI2_REL = 1e-8          # chi2 inside the health vector, the same
SAME_ARRAYS = 1e-12      # the solve's and chunk's vectors on one input
BAND = 1e-5              # the drift band of the float64 routes
ENV = ("PINT_TPU_HEALTH", "PINT_TPU_SHADOW_RATE",
       "PINT_TPU_HEALTH_DRIFT_SIGMA", "PINT_TPU_HEALTH_CHI2_FACTOR",
       "PINT_TPU_HEALTH_RESID_SIGMA", "PINT_TPU_HEALTH_CG_BUDGET_FRAC",
       "PINT_TPU_GLS_MATMUL", "PINT_TPU_JAC", "PINT_TPU_FLIGHT_DIR",
       "PINT_TPU_TRACE", "PINT_TPU_DISPATCH_RTT_MS")


def _ns(which):
    if which == "ref":
        import pint_tpu.config as cfg
        import pint_tpu.runtime as rt
        from pint_tpu import obs
        from pint_tpu.obs import health as oh
        from pint_tpu.obs import metrics as om
    else:
        import pint_tpu_torch.config as cfg
        import pint_tpu_torch.runtime as rt
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import health as oh
        from pint_tpu_torch.obs import metrics as om
    return types.SimpleNamespace(name=which, config=cfg, rt=rt, obs=obs,
                                 oh=oh, om=om)


def _reset(ns):
    ns.rt.reset_runtime()
    ns.obs.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for which in ("ref", "port"):
        _reset(_ns(which))
    yield
    for which in ("ref", "port"):
        _reset(_ns(which))


# ------------------------------------------------------------ scenarios


def s_parsers(ns, mp, tmp):
    cfg, out = ns.config, []
    out.append(cfg.health_enabled())
    for v in ("on", "banana"):
        mp.setenv("PINT_TPU_HEALTH", v)
        out.append(cfg.health_enabled())
    out.append(cfg.health_enabled(True))
    for v in ("256", "-3", "pear"):
        mp.setenv("PINT_TPU_SHADOW_RATE", v)
        out.append(cfg.shadow_rate())
    out.append(cfg.health_drift_sigma())
    for v in ("2e-2", "-1", "inf"):
        mp.setenv("PINT_TPU_HEALTH_DRIFT_SIGMA", v)
        out.append(cfg.health_drift_sigma())
    for v in ("0.5", "8"):
        mp.setenv("PINT_TPU_HEALTH_CHI2_FACTOR", v)
        out.append(cfg.health_chi2_factor())
    for v in ("2.0", "0.5"):
        mp.setenv("PINT_TPU_HEALTH_CG_BUDGET_FRAC", v)
        out.append(cfg.health_cg_budget_frac())
    mp.setenv("PINT_TPU_HEALTH_RESID_SIGMA", "0")
    out.append(cfg.health_resid_sigma())
    return out


def s_disarmed(ns, mp, tmp):
    oh, om = ns.oh, ns.om
    v = oh.observe("fit.device", {"values": [np.array([np.nan])]})
    reg = om.get_registry()
    g = reg.get("pint_tpu_health_last_value")
    return [v, oh.status(), reg.total("pint_tpu_health_incidents_total"),
            g is None or g.series() == []]


def s_thresholds(ns, mp, tmp):
    ns.obs.configure(enabled=True, flight_dir=str(tmp / ns.name))
    mon = ns.oh.configure(enabled=True)
    reg = ns.om.get_registry()
    out = [mon.observe("fit.device", {"hv": np.array([0.0, 2.5, 100.0])},
                       key="k"),
           reg.value("pint_tpu_health_last_value", kind="fit.device",
                     signal="max_resid_sigma"),
           mon.observe("fit.device", {"values": [np.array([1.0, np.nan])]},
                       key="k"),
           mon.observe("stream.solve", {"cg_iters": 64, "cg_budget": 64,
                                        "cg_rel_residual": 1e-3,
                                        "ok": False}),
           reg.total("pint_tpu_health_cg_budget_exhausted_total"),
           mon.observe("fit.device", {"chi2": 500.0, "chi2_prev": 100.0}),
           mon.observe("fit.device", {"chi2": 101.0, "chi2_prev": 100.0}),
           mon.observe("fit.device", {"max_resid_sigma": 1e12}),
           mon.observe("gls", {"drift_sigma": 1.0}, pool="shadow"),
           mon.observe("posterior.chunk",
                       {"lnpost": np.array([-1.0, -np.inf, np.inf]),
                        "accept_frac": 0.3}),
           reg.total("pint_tpu_health_shadow_drift_exceeded_total")]
    st = mon.status()
    out.append({k: st[k] for k in ("armed", "incidents", "shadow_rate",
                                   "drift_band_sigma",
                                   "cg_budget_exhausted")})
    out.append(st["last_incident"]["reason"])
    out.append({k: (v["ok"], v["reasons"]) for k, v in st["worst"].items()})
    out.append(st["cg_iters"]["stream.solve"]["count"])
    out.append(st["drift"]["gls"]["count"])
    return out


def s_incident_dump(ns, mp, tmp):
    fdir = tmp / ns.name
    ns.obs.configure(enabled=True, flight_dir=str(fdir))
    mon = ns.oh.configure(enabled=True)
    for _ in range(4):
        mon.observe("fit.device", {"values": [np.array([np.nan])]}, key="k")
    dumps = list(fdir.glob("flight-*numerics_nonfinite*.json"))
    doc = json.loads(dumps[0].read_text())
    return [int(ns.om.get_registry().total(
        "pint_tpu_health_incidents_total")), len(dumps), doc["reason"],
        doc["extra"]["kind"], doc["extra"]["signals"]]


def s_shadow_due(ns, mp, tmp):
    mon = ns.oh.configure(enabled=True, shadow_rate=4)
    return [mon.shadow_due("k") for _ in range(9)] + \
        [mon.shadow_due("other")]


def s_shadow_only(ns, mp, tmp):
    mon = ns.oh.configure(enabled=False, shadow_rate=8)
    v = mon.observe("gls", {"drift_sigma": 1.0}, pool="shadow")
    return [v, int(ns.om.get_registry().total(
        "pint_tpu_health_shadow_drift_exceeded_total")),
        ns.oh.status() is not None,
        mon.observe("fit.device", {"chi2": 1.0})]


def s_ages_out(ns, mp, tmp):
    mon = ns.oh.configure(enabled=True)
    mon.observe("gls.solve", {"values": [np.array([np.nan])]})
    out = [ns.om.default_health()["ok"]]
    mon.observe("gls.solve", {"values": [np.array([1.0])]})
    w = mon.status()["worst"]["device/gls.solve"]
    out += [w["ok"], w["last_good_age_s"] >= 0.0]
    with mon._lock:
        mon._worst[("device", "gls.solve")]["t"] -= ns.oh._WORST_TTL_S + 1
    mon.observe("gls.solve", {"values": [np.array([1.0])]})
    out += [mon.status()["worst"]["device/gls.solve"]["ok"],
            ns.om.default_health()["ok"]]
    return out


def s_nonfinite_drift(ns, mp, tmp):
    mon = ns.oh.configure(enabled=True, shadow_rate=1)
    mon.shadow_replay("gls", "k", lambda: float("inf"), wait=True)
    mon.shadow_replay("gls", "k", lambda: float("nan"), wait=True)
    mon.shadow_replay("gls", "k", lambda: None, wait=True)

    def broken():
        raise RuntimeError("mirror broke")

    mon.shadow_replay("gls", "k", broken, wait=True)
    st = mon.status()
    return [int(ns.om.get_registry().total(
        "pint_tpu_health_shadow_drift_exceeded_total")),
        st["last_incident"]["reason"], st["shadow_replays"],
        st.get("drift", {}).get("gls", {"count": 0})["count"]]


def s_healthz(ns, mp, tmp):
    mon = ns.oh.configure(enabled=True)
    mon.observe("gls.solve", {"values": [np.array([np.nan])]},
                pool="device", key="gls.solve")
    h = ns.om.default_health()
    return [h["numerics"]["incidents"],
            h["numerics"]["worst"]["device/gls.solve"]["ok"], h["ok"]]


def s_drift_sigma(ns, mp, tmp):
    cov = np.diag([4.0, 0.0, 1e-6])
    return [ns.oh.drift_sigma(np.array([1.0, 2.0, 3.0]), cov,
                              np.array([1.2, 2.5, 3.0 + 1e-3]))]


SHARED = {
    "test_health_env_parsers_warn_and_ignore": s_parsers,
    "test_disarmed_observe_records_nothing": s_disarmed,
    "test_thresholds_and_verdicts": s_thresholds,
    "test_incident_flight_dump_rate_limited": s_incident_dump,
    "test_shadow_due_is_deterministic": s_shadow_due,
    "test_shadow_only_arming_records_drift": s_shadow_only,
    "test_bad_verdict_ages_out_of_healthz": s_ages_out,
    "test_nonfinite_shadow_drift_is_an_incident_not_a_crash":
        s_nonfinite_drift,
    "test_healthz_and_snapshot_carry_the_verdict_block": s_healthz,
    "drift_sigma": s_drift_sigma,
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_semantics(case, monkeypatch, tmp_path):
    got = {}
    for which in ("ref", "port"):
        ns = _ns(which)
        with monkeypatch.context() as mp:
            _reset(ns)
            got[which] = SHARED[case](ns, mp, tmp_path)
            _reset(ns)
    assert got["port"] == got["ref"]


# ----------------------------------------------- taps, against the ref


def _compiled_core(monkeypatch):
    """The reference's _gls_core compiled inside its eager step (eagerly
    it takes ~10 s a call)."""
    core = jax.jit(r_fit_step._gls_core, static_argnums=(8,),
                   static_argnames=("f32mm",))

    def compiled_core(*a, **kw):
        with jax.disable_jit(False):
            return core(*a, **kw)

    monkeypatch.setattr(r_fit_step, "_gls_core", compiled_core)


def _hv_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got[0] == want[0] == 0.0
    assert got[1] == pytest.approx(want[1], rel=RESID_SIGMA_REL)
    assert got[2] == pytest.approx(want[2], rel=CHI2_REL)


def test_step_health_matches_reference(monkeypatch):
    """The armed step's fifth output against the reference's
    ``_build_fit_core(health=True)``; within the port, outputs 0-3
    bitwise the disarmed step's and the vector the host's own
    reductions of them."""
    rm, tm, rt, tt = _problem()
    _compiled_core(monkeypatch)
    rstep, _, rargs, _, rmeta = r_fit_step._build_fit_core(
        rm, rt, health=True, **REF_FLAGS)
    assert rmeta["health"]
    with jax.disable_jit():
        ref = [np.asarray(x) for x in rstep(*rargs)]
    step, args, _ = build_fit_step(tm, tt, health=True)
    out = step(*args)
    assert len(out) == 5 and len(ref) == 5
    _hv_close(out[4], ref[4])
    plain, pargs, _ = build_fit_step(tm, tt, health=False)
    base = plain(*pargs)
    assert len(base) == 4
    for a, b in zip(out[:4], base):
        assert torch.equal(a, b)
    r, nvec = out[3].numpy(), args[8].numpy()
    hv = out[4].numpy()
    assert hv[1] == pytest.approx(np.max(np.abs(r) / np.sqrt(nvec)),
                                  rel=SAME_ARRAYS)
    assert hv[2] == float(out[2])


def test_disarmed_step_runs_the_same_ops(monkeypatch):
    """Disarmed (the default, $PINT_TPU_HEALTH unset) the step runs
    exactly the ops of a step built with ``health=False``; armed, the
    same ops followed by the vector's few reductions, and the same
    outputs 0-3 bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    _, tm, _, tt = _problem()
    runs = {}
    for flag in (None, False, True):
        step, args, _ = build_fit_step(tm, tt, health=flag)
        with Ops() as rec:
            out = step(*args)
        runs[flag] = (rec.ops, out)
    assert runs[None][0] == runs[False][0]
    armed = runs[True][0]
    assert armed[:len(runs[False][0])] == runs[False][0]
    assert 0 < len(armed) - len(runs[False][0]) <= 40
    for a, b, c in zip(runs[None][1], runs[False][1], runs[True][1]):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_loop_health_matches_reference(monkeypatch):
    """The loop's twelfth output (the accepted state's vector) against
    the reference loop's, run eagerly; within the port it is the armed
    step's vector at the loop's final point, bit for bit."""
    rm, tm, rt, tt = _problem()
    _compiled_core(monkeypatch)
    from pint_tpu.parallel import build_fit_loop as r_build_fit_loop

    rloop, rargs, _ = r_build_fit_loop(rm, rt, max_iter=4, health=True,
                                       **REF_FLAGS)
    with jax.disable_jit():
        ref = [np.asarray(x) for x in rloop(*rargs)]
    loop_fn, args, _ = build_fit_loop(tm, tt, max_iter=4, health=True)
    out = loop_fn(*args)
    assert len(out) == 12 and len(ref) == 12
    assert out[6] == int(ref[6])
    _hv_close(out[11], ref[11])
    step, sargs, _ = build_fit_step(tm, tt, health=True)
    at_end = step(out[0], out[1], *sargs[2:])
    assert torch.equal(out[11], at_end[4])
    # the entry's vector rides a chained call that accepts nothing
    again = loop_fn(out[0], out[1], *args[2:-1], 0,
                    entry=out[2:5] + (out[11],))
    assert again[6] == 0 and torch.equal(again[11], out[11])
    plain_fn, pargs, _ = build_fit_loop(tm, tt, max_iter=4)
    assert len(plain_fn(*pargs)) == 11


def test_gls_kernel_health_matches_reference():
    """``_gls_kernel(health=True)``'s seventh output against the
    reference's on the same arrays (the port's own pass)."""
    _, tm, _, tt = _problem()
    M, r, nvec, F, phi, _, _ = GLSFitter(tt, tm)._system()
    arrs = [x.numpy() for x in (M, F, phi, r, nvec)]
    out = pgls._gls_kernel(M, F, phi, r, nvec, health=True)
    ref = r_gls_kernel(*(jax.numpy.asarray(a) for a in arrs),
                       health=True)
    assert len(out) == 7 and len(ref) == 7
    hv, rhv = out[6].numpy(), np.asarray(ref[6])
    assert hv[0] == rhv[0] == 0.0
    assert hv[1] == pytest.approx(rhv[1], rel=SAME_ARRAYS)
    # chi2 = sum(r^2 w) - xhat.b cancels: the compiled and eager
    # orders part at ~1e-10 of it
    assert hv[2] == pytest.approx(rhv[2], rel=CHI2_REL)
    assert abs(hv[3] - rhv[3]) <= SAME_ARRAYS
    base = pgls._gls_kernel(M, F, phi, r, nvec)
    assert len(base) == 6
    for a, b in zip(out[:6], base):
        assert torch.equal(a, b)


def test_acc_chunk_health_matches_reference():
    """``_acc_chunk(health=True)``'s [nonfinite, rescale] against the
    reference's on one random chunk with a NaN residual and a column
    that grows the running max."""
    rng = np.random.default_rng(3)
    C, p, q = 64, 4, 3
    M = rng.normal(size=(C, p))
    M[:, 2] *= 50.0
    Fv = rng.normal(size=(C, q))
    r0 = rng.normal(size=C)
    r0[5] = np.nan
    nvec = rng.uniform(0.5, 2.0, C)
    valid = np.ones(C)
    valid[-3:] = 0.0
    tmask = valid.copy()
    st = p_stream.acc_init_np(p, q)
    st[0] = np.array([1.0, 2.0, 3.0, 0.5])
    ref = r_stream._acc_chunk(
        tuple(jax.numpy.asarray(x) for x in st), *(jax.numpy.asarray(a)
        for a in (M, Fv, r0, nvec, valid)),
        jax.numpy.zeros(C, jax.numpy.int32), jax.numpy.zeros(C),
        jax.numpy.asarray(tmask), f32mm=False, has_ecorr=False,
        health=True)
    tst = tuple(torch.as_tensor(np.asarray(x)) for x in st)
    t = [torch.as_tensor(a) for a in (M, Fv, r0, nvec, valid, tmask)]
    out = p_stream._acc_chunk(tst, *t, health=True)
    hv, rhv = out[1].numpy(), np.asarray(ref[1])
    assert hv[0] == rhv[0] == p + q + 1
    assert hv[1] == pytest.approx(rhv[1], rel=SAME_ARRAYS)
    assert hv[1] > 1.0
    base = p_stream._acc_chunk(tst, *t)
    for a, b in zip(out[0], base):
        assert torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)


# ----------------------------------------------------- the port's taps


def _pmon(enabled=True, shadow_rate=0):
    from pint_tpu_torch.obs import health as oh

    return oh.configure(enabled=enabled, shadow_rate=shadow_rate)


def _wait_replays(mon, n, timeout=60.0):
    t0 = time.monotonic()
    while mon._c_shadow.total() < n and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
    assert mon._c_shadow.total() >= n, "shadow never replayed"


def _exceeded():
    from pint_tpu_torch.obs import metrics as om

    return int(om.get_registry().total(
        "pint_tpu_health_shadow_drift_exceeded_total"))


def test_shadow_detector_detects_unsanctioned_f32(monkeypatch, tmp_path):
    """GLSFitter's Cholesky shadow: the float64 replay on the numpy
    mirror sits in the band; a float32 Gram forced into the solve (an
    unsanctioned demotion) leaves it and fires the drift incident and
    its flight dump."""
    from pint_tpu_torch import obs

    _, tm, _, tt = _problem()
    obs.configure(enabled=False, flight_dir=str(tmp_path))
    mon = _pmon(shadow_rate=1)
    assert mon.drift_band == BAND
    GLSFitter(tt, copy.deepcopy(tm)).fit_toas(maxiter=1)
    _wait_replays(mon, 2)
    assert _exceeded() == 0
    assert mon.status()["drift"]["gls"]["count"] == 2
    monkeypatch.setattr(pgls, "_symm_mm",
                        lambda X, Y: (X.float().T @ Y.float()).double())
    GLSFitter(tt, copy.deepcopy(tm)).fit_toas(maxiter=1)
    _wait_replays(mon, 4)
    assert _exceeded() >= 1
    assert mon.status()["last_incident"]["reason"] == "drift"
    assert list(tmp_path.glob("flight-*numerics_drift*.json"))


def _degenerate_pair():
    """tests/test_health.py's degenerate model (two identical DMX
    windows) and TOAs, as the port's."""
    from pint_tpu.models import get_model as r_get_model
    from pint_tpu.simulation import make_fake_toas_uniform

    from test_health import PAR

    par = PAR + ("DMX_0001 0.0 1\nDMXR1_0001 54000\nDMXR2_0001 56000\n"
                 "DMX_0002 0.0 1\nDMXR1_0002 54000\nDMXR2_0002 56000\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm = r_get_model(io.StringIO(par))
        rt = make_fake_toas_uniform(
            54100, 55900, 80, rm, error_us=1.0, add_noise=True,
            freq_mhz=np.tile([1400.0, 820.0], 40),
            rng=np.random.default_rng(23))
        tm = get_model(io.StringIO(par), device=CPU)
    return tm, toas_from_columns(rt, CPU)


def test_degenerate_route_is_neither_shadowed_nor_an_incident():
    """The designed degenerate route (Cholesky ok False -> warn -> eigh
    retry) under full shadow sampling: the shadow declines the failed
    Cholesky, and the handled fallback fires no incident."""
    from pint_tpu_torch.fitter import DegeneracyWarning
    from pint_tpu_torch.obs import metrics as om

    tm, tt = _degenerate_pair()
    mon = _pmon(shadow_rate=1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        chi2 = GLSFitter(tt, tm).fit_toas(maxiter=1)
    assert np.isfinite(chi2)
    assert any(w.category is DegeneracyWarning for w in rec)
    _wait_replays(mon, 2)
    assert _exceeded() == 0
    assert mon.status().get("drift") is None   # every replay declined
    assert int(om.get_registry().total(
        "pint_tpu_health_incidents_total")) == 0
    assert mon.status()["worst"]["device/gls.solve"]["ok"]


def test_streaming_shadow_replays_same_state():
    """The finalize's shadow replays the SAME accumulated state through
    the numpy CG mirror: the float64 floor, never an incident; the CG
    effort and the chunk vector ride the pass."""
    _, tm, _, tt = _problem()
    mon = _pmon(shadow_rate=1)
    sg = p_stream.StreamingGLS(tm, tt, chunk=64, device=CPU, health=True)
    state = sg.accumulate(sg.th0, sg.tl0)
    assert sg.last_pass_hv is not None and sg.last_pass_hv[0] == 0.0
    out = sg.solve(state)
    assert out[5]
    _wait_replays(mon, 1)
    assert _exceeded() == 0
    st = mon.status()
    assert st["cg_iters"]["stream.solve"]["count"] == 1
    assert st["worst"]["device/stream.chunk"]["ok"]
    assert st["worst"]["device/stream.solve"]["ok"]
    assert st["worst"]["shadow/stream"]["ok"]


def test_health_tap_zero_extra_dispatches():
    """An armed device fit observes health from the SAME supervised
    dispatches a disarmed fit issues, and lands on the same point."""
    from pint_tpu_torch.runtime import get_supervisor, reset_runtime

    _, tm, _, tt = _problem()
    models, counts = [], []
    for armed in (False, True):
        m = copy.deepcopy(tm)
        mon = _pmon(enabled=armed)
        reset_runtime()
        DeviceDownhillGLSFitter(tt, m, health=armed).fit_toas(maxiter=3)
        counts.append(get_supervisor().snapshot()["dispatches"])
        models.append(m)
    assert counts[0] == counts[1]
    for n in tm.free_params:
        assert models[0].get_param(n).value == models[1].get_param(n).value
    assert mon.status()["worst"]["device/fit.device"]["ok"]


def test_nan_step_fires_one_nonfinite_dump_and_fails_over(tmp_path):
    """A NaN readback of every device-fit dispatch: one
    ``numerics:nonfinite`` dump for the episode, and the fit still
    fails over to the host fitter's result."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.gls import DownhillGLSFitter
    from pint_tpu_torch.runtime import Fault, FaultPlan

    _, tm, _, tt = _problem()
    th = copy.deepcopy(tm)
    obs.configure(enabled=False, flight_dir=str(tmp_path))
    _pmon()
    with FaultPlan([Fault(match="gls.fit", kind="nan")]).active():
        with pytest.warns(RuntimeWarning, match="fell back"):
            chi2 = DeviceDownhillGLSFitter(tt, tm).fit_toas()
    assert len(list(tmp_path.glob("flight-*numerics_nonfinite*.json"))) == 1
    assert chi2 == DownhillGLSFitter(tt, th).fit_toas()


def test_chain_chunk_is_observed_for_its_pool():
    """``posterior.chunk``: a chain's chunks observed on the device
    pool (here the CPU device: no failover), ok on a healthy
    posterior; a NaN log-posterior walker is a nonfinite incident."""
    from pint_tpu_torch.sampling.chain import DeviceEnsembleSampler

    mon = _pmon()

    def lnpost(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    p0 = np.random.default_rng(1).normal(size=(8, 2))
    DeviceEnsembleSampler(8, 2, lnpost, device=CPU).run_mcmc(p0, 16)
    assert mon.status()["worst"]["device/posterior.chunk"]["ok"]

    def lnpost_nan(x):
        out = lnpost(x)
        return torch.where(x[:, 0] > 1e6, torch.nan, out) + \
            torch.where(torch.arange(x.shape[0]) == 0, torch.nan, 0.0)

    DeviceEnsembleSampler(8, 2, lnpost_nan, device=CPU).run_mcmc(p0, 16)
    w = mon.status()["worst"]["device/posterior.chunk"]
    assert not w["ok"] and w["reasons"] == ["nonfinite"]


def test_armed_step_arity_is_handled_by_every_consumer(monkeypatch):
    """grid_chisq consumes the raw fit step: with health armed by the
    environment its fifth output must not break it."""
    from pint_tpu_torch.gridutils import grid_chisq

    _, tm, _, tt = _problem()
    monkeypatch.setenv("PINT_TPU_HEALTH", "on")
    f0 = float(tm.F0.value)
    grid = grid_chisq(tm, tt, ["F0"], [np.array([f0 - 1e-9, f0, f0 + 1e-9])],
                      maxiter=1)
    assert np.asarray(grid).shape == (3,)
    assert np.all(np.isfinite(np.asarray(grid)))
