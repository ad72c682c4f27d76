"""The serve layer of the port (pint_tpu_torch.serve) held to the
reference's pint_tpu.serve on the CPU: the 30 cases of tests/test_serve.py
through both packages, plus the port's own device programs.

``test_shared_semantics[...]`` runs one scenario of tests/test_serve.py
through each package (the reference's engine and the port's engine on
``device="cpu"``, each on its own package's models of the same simulated
pulsars) and holds the outcomes equal: counters, shed labels, routing,
class accounting exactly; chi2 values within 1e-6 relative (the two
packages' design matrices and residuals differ by ~1e-10 of each column's
largest entry, tests/test_torch_pta.py).

Numerics:

- on the SAME prebuilt problems, the port's batched solve is held to the
  reference engine's within 1e-8 relative (atol 1e-15 on dparams), the
  limit tests/test_torch_pta.py holds the batch solve to; coalesced,
  pipelined, sequential and threaded port engines to one another within
  the reference's 1e-9 relative;
- served phases to ``PolycoEntry.abs_phase`` within 10 ps of phase (the
  reference's budget), and the batched ``_phase_eval_one`` bitwise to the
  reference's run under ``jax.disable_jit()`` (the same IEEE operations);
- the batched append slot to the reference's compiled one within 1e-9
  relative, each slot of ``_cg_schur_batch`` to ``_cg_schur`` of that
  slot alone within 1e-12 relative (a batched triangular solve rounds
  differently from the unbatched ``cholesky_solve``) and to the numpy
  mirror ``append_slot_np`` within 1e-9.

``test_mesh_refused`` replaces the reference's mesh-engine case: the port
has no device mesh and refuses ``mesh=`` (parallel.pta.MESH_REFUSAL).
"""

import contextlib
import io
import json
import os
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns

from test_serve import TEN_PS_TURNS, _mk

CPU = "cpu"
DATADIR = os.path.join(os.path.dirname(__file__), "datafile")


def _port_pair(m, t):
    """The port's (model, toas) of a reference pair: its par text and
    its TOA columns."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (get_model(io.StringIO(m.as_parfile()), device=CPU),
                toas_from_columns(t, CPU))


@pytest.fixture(scope="module")
def ref_zoo():
    """tests/test_serve.py's zoo: six pulsars across three TOA buckets,
    one with a correlated-noise basis."""
    return [_mk(0, 50), _mk(1, 60), _mk(2, 100), _mk(3, 120),
            _mk(4, 200), _mk(5, 90, noise=True)]


@pytest.fixture(scope="module")
def port_zoo(ref_zoo):
    return [_port_pair(m, t) for m, t in ref_zoo]


@pytest.fixture(scope="module")
def problems(ref_zoo):
    """The reference's prebuilt problems: the SAME inputs for both
    engines."""
    from pint_tpu.parallel.pta import build_problem

    return [build_problem(t, m) for m, t in ref_zoo]


@pytest.fixture(autouse=True)
def clean_runtime():
    import pint_tpu.runtime as rrt
    import pint_tpu_torch.runtime as prt

    rrt.reset_runtime()
    prt.reset_runtime()
    yield
    rrt.reset_runtime()
    prt.reset_runtime()


def _ns(which, ref_zoo, port_zoo):
    if which == "ref":
        import pint_tpu.config as config
        import pint_tpu.runtime as rt
        import pint_tpu.serve as serve
        from pint_tpu.polycos import PolycoEntry
        from pint_tpu.scripts import pint_serve
        kw, zoo = {}, ref_zoo
    else:
        import pint_tpu_torch.config as config
        import pint_tpu_torch.runtime as rt
        import pint_tpu_torch.serve as serve
        from pint_tpu_torch.polycos import PolycoEntry
        from pint_tpu_torch.scripts import pint_serve
        kw, zoo = {"device": CPU}, port_zoo
    return types.SimpleNamespace(
        name=which, serve=serve, config=config, rt=rt, zoo=zoo,
        cli=pint_serve, PolycoEntry=PolycoEntry,
        Engine=lambda **k: serve.ServeEngine(**kw, **k))


def _entry(ns, seed=0):
    return ns.PolycoEntry(
        psrname="DEMO", tmid=55000.0 + seed, rphase_int=1e9,
        rphase_frac=0.25, f0=200.0, obs="@", span_min=60.0,
        coeffs=np.array([0.02, 1e-3, -2e-5, 1e-7]))


def _raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


# ----------------------------------------------------------- scenarios


def s_compile_count_bounded(ns, mp, tmp):
    eng = ns.Engine()
    futs = []
    for _ in range(3):
        for m, t in ns.zoo:
            futs.append(eng.submit(ns.serve.FitStepRequest(t, m)))
        eng.flush()
    chi2 = [f.result(timeout=0).chi2 for f in futs]
    snap = eng.metrics.snapshot()
    return [snap["completed"], snap["compile_count"],
            snap["bucket_count"], chi2[:len(ns.zoo)]]


def s_backpressure(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine(queue_cap=2)
    eng.submit(ns.serve.FitStepRequest(t, m))
    eng.submit(ns.serve.ResidualsRequest(t, m))
    raised = _raises(lambda: eng.submit(ns.serve.FitStepRequest(t, m)),
                     ns.serve.ServeOverload)
    rejected = eng.metrics.rejected
    eng.flush()
    return [raised, rejected, eng.metrics.completed]


def s_deadline_expires(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine()
    fut = eng.submit(ns.serve.FitStepRequest(t, m, deadline_s=1e-4))
    live = eng.submit(ns.serve.ResidualsRequest(t, m))
    time.sleep(0.02)
    eng.flush()
    return [_raises(lambda: fut.result(timeout=0),
                    ns.serve.DeadlineExceeded),
            live.result(timeout=0).chi2, eng.metrics.deadline_missed]


def s_oversize_single(ns, mp, tmp):
    m, t = ns.zoo[4]
    eng = ns.Engine(bucket_edges=(64,))
    sm, st = ns.zoo[0]
    futs = [eng.submit(ns.serve.FitStepRequest(t, m)),
            eng.submit(ns.serve.FitStepRequest(st, sm))]
    eng.flush()
    big = futs[0].result(timeout=0)
    ref = ns.Engine().submit(ns.serve.FitStepRequest(t, m)).result()
    return [bool(np.array_equal(big.dparams, ref.dparams)),
            eng.metrics.fallback_single, futs[1].result(timeout=0).chi2,
            big.chi2]


def s_oversize_shared(ns, mp, tmp):
    m, t = ns.zoo[4]
    eng = ns.Engine(bucket_edges=(64,))
    futs = [eng.submit(ns.serve.FitStepRequest(t, m)) for _ in range(3)]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    fb = [b for k, b in eng.metrics.buckets.items() if k[1] == 256]
    snap = eng.metrics.snapshot()
    ref = ns.Engine().submit(ns.serve.FitStepRequest(t, m)).result()
    close = all(np.allclose(r.dparams, ref.dparams, rtol=1e-9, atol=1e-18)
                and r.chi2 == pytest.approx(ref.chi2, rel=1e-9)
                for r in res)
    return [eng.metrics.fallback_single, len(fb), fb[0].batches,
            fb[0].requests, snap["compile_count"] <= snap["bucket_count"],
            close]


def s_empty_snapshot(ns, mp, tmp):
    eng = ns.Engine()
    snap = json.loads(eng.metrics.to_json())
    eng.metrics.report()
    keys = set(snap) - {"scoreboard", "slo", "health"}
    return [snap["p50_ms"], snap["p99_ms"], snap["completed"],
            sorted(keys)]


def s_failed_dispatch(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine()
    eng.cache._gls = None  # force the dispatch to blow up
    fut = eng.submit(ns.serve.FitStepRequest(t, m))
    eng.flush()
    return [_raises(lambda: fut.result(timeout=0), TypeError),
            eng.metrics.failed, eng.metrics.compile_count]


def s_phase_partial_submit(ns, mp, tmp):
    class StubEngine:
        def __init__(self, cap):
            self.cap = cap
            self.submitted = []

        def submit(self, req):
            if len(self.submitted) >= self.cap:
                raise ns.serve.ServeOverload("full")
            self.submitted.append(req)
            return req.future

    mjds = [55000.0, 55000.001, 55000.04, 55000.041, 55000.08]
    pad = 60.0 / 1440.0
    pcs = types.SimpleNamespace(
        entries=[_entry(ns, 0), _entry(ns, 1), _entry(ns, 2)],
        _entry_for=lambda m: np.array([0, 0, 1, 1, 2]))
    cache = {("polyco", "fake.par", "@", round(min(mjds) - pad, 6),
              round(max(mjds) + pad, 6), 60.0): pcs}
    eng = StubEngine(cap=2)
    emitted, reported = [], []
    n = ns.cli._submit_line(
        eng, cache, {"kind": "phase", "par": "fake.par", "id": "r1",
                     "mjds": mjds}, emitted.append, reported.append)
    return [n, len(eng.submitted), len(reported),
            reported[0]["segments_submitted"],
            reported[0]["segments_shed"],
            "ServeOverload" in reported[0]["error"]]


def s_expired_shed_while_queued(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine()
    doomed = eng.submit(ns.serve.FitStepRequest(t, m, deadline_s=0.01))
    time.sleep(0.03)
    live = eng.submit(ns.serve.ResidualsRequest(t, m))
    done_before_flush = doomed.done()
    snap = eng.metrics.snapshot()
    eng.flush()
    return [done_before_flush,
            _raises(lambda: doomed.result(timeout=0),
                    ns.serve.DeadlineExceeded),
            snap["admission"]["shed_expired"], snap["deadline_missed"],
            live.result(timeout=0).chi2]


def s_tenant_quota(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine(tenant_qps=0.001, tenant_burst=2)
    ok = [eng.submit(ns.serve.FitStepRequest(t, m, tenant="noisy")),
          eng.submit(ns.serve.ResidualsRequest(t, m, tenant="noisy"))]
    raised = _raises(lambda: eng.submit(
        ns.serve.FitStepRequest(t, m, tenant="noisy")),
        ns.serve.TenantOverQuota)
    ok.append(eng.submit(ns.serve.FitStepRequest(t, m, tenant="quiet")))
    eng.flush()
    adm = eng.metrics.snapshot()["admission"]
    return [raised, [f.result(timeout=0).chi2 for f in ok],
            adm["shed_quota"], adm["tenants"]]


def s_deadline_aware(ns, mp, tmp):
    m, t = ns.zoo[0]
    S = ns.serve
    eng = ns.Engine(queue_cap=2, shed_policy="deadline")
    eng.router.seed_rate("device", "gls", 1.0)
    doomed = eng.submit(S.FitStepRequest(t, m, deadline_s=5.0))
    live = eng.submit(S.ResidualsRequest(t, m))
    new = eng.submit(S.FitStepRequest(t, m))
    out = [doomed.done(), _raises(lambda: doomed.result(timeout=0),
                                  S.DeadlineExceeded),
           eng.admission.shed_deadline]
    doomed2 = eng.submit(S.FitStepRequest(t, m, deadline_s=0.5))
    out += [doomed2.done(), _raises(lambda: doomed2.result(timeout=0),
                                    S.DeadlineExceeded),
            eng.admission.shed_deadline,
            _raises(lambda: eng.submit(S.FitStepRequest(t, m)),
                    S.ServeOverload)]
    eng.flush()
    return out + [live.result(timeout=0).chi2, new.result(timeout=0).chi2]


def s_position_aware(ns, mp, tmp):
    m, t = ns.zoo[0]
    S = ns.serve
    eng = ns.Engine(queue_cap=3, shed_policy="deadline")
    head_req = S.FitStepRequest(t, m, deadline_s=2.0)
    head = eng.submit(head_req)
    eng.submit(S.FitStepRequest(t, m))
    eng.submit(S.ResidualsRequest(t, m))
    eng.router.seed_rate("device", "gls",
                         float(head_req.problem.M.shape[0]))
    raised = _raises(lambda: eng.submit(S.FitStepRequest(t, m)),
                     S.ServeOverload)
    out = [raised, head.done(), eng.admission.shed_deadline]
    eng.flush()
    return out


def s_reject_policy(ns, mp, tmp):
    m, t = ns.zoo[0]
    S = ns.serve
    eng = ns.Engine(queue_cap=1, shed_policy="reject")
    eng.router.seed_rate("device", "gls", 1.0)
    queued = eng.submit(S.FitStepRequest(t, m, deadline_s=60.0))
    raised = _raises(lambda: eng.submit(S.FitStepRequest(t, m)),
                     S.ServeOverload)
    return [raised, queued.done(), eng.admission.shed_deadline]


def s_breaker_demotion(ns, mp, tmp):
    m, t = ns.zoo[2]
    S = ns.serve
    ref = ns.Engine().submit(S.FitStepRequest(t, m)).result()
    eng = ns.Engine()
    br = ns.rt.breaker_for("cpu")
    for _ in range(br.threshold):
        br.on_result(False)
    futs = [eng.submit(S.FitStepRequest(t, m)),
            eng.submit(S.ResidualsRequest(t, m))]
    eng.flush()
    res = [f.result(timeout=0) for f in futs]
    snap = eng.metrics.snapshot()
    rt = snap["router"]
    return [br.state == ns.rt.OPEN,
            bool(np.allclose(res[0].dparams, ref.dparams, rtol=1e-8,
                             atol=1e-15)),
            res[0].chi2 == pytest.approx(ref.chi2, rel=1e-8),
            rt["host"]["dispatches"], rt["host"]["demotions"],
            rt["device"]["dispatches"], snap["dispatch"]["failovers"],
            snap["dispatch"]["breaker_rejections"],
            "pools:" in eng.metrics.report()]


def s_router_steers(ns, mp, tmp):
    m, t = ns.zoo[0]
    eng = ns.Engine()
    eng.router.seed_rate("host", "gls", 1e12)
    eng.router.seed_rate("device", "gls", 1e-3)
    fut = eng.submit(ns.serve.FitStepRequest(t, m))
    eng.flush()
    chi2 = fut.result(timeout=0).chi2
    rt = eng.metrics.snapshot()["router"]
    eng2 = ns.Engine()
    fut = eng2.submit(ns.serve.FitStepRequest(t, m))
    eng2.flush()
    fut.result(timeout=0)
    return [chi2, rt["host"]["dispatches"], rt["device"]["dispatches"],
            eng2.metrics.snapshot()["router"]["host"]["dispatches"]]


def s_startup_shutdown(ns, mp, tmp):
    def dies_in_ctor(*a, **k):
        raise ns.cli._Shutdown("SIGTERM")

    mp.setattr(ns.serve, "ServeEngine", dies_in_ctor)
    feed = [json.dumps({"kind": "fit_step", "par": "x.par",
                        "tim": "x.tim", "id": "a"}) + "\n",
            json.dumps({"kind": "phase", "entry": "DEMO",
                        "mjds": [55000.0], "id": "b"}) + "\n",
            "# comment\n", "\n"]
    buf = io.StringIO()
    argv = [] if ns.name == "ref" else ["--device", CPU]
    with contextlib.redirect_stdout(buf):
        rc = ns.cli.main(argv, stdin=feed)
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    return [rc, lines]


def s_bucket_env(ns, mp, tmp):
    cfg = ns.config
    mp.setenv("PINT_TPU_SERVE_BUCKETS", "128, 32,512")
    out = [cfg.serve_bucket_edges()]
    mp.setenv("PINT_TPU_SERVE_BUCKETS", "banana")
    out.append(cfg.serve_bucket_edges())
    mp.delenv("PINT_TPU_SERVE_BUCKETS")
    return out + [cfg.serve_bucket_edges()]


def s_env_knobs(ns, mp, tmp):
    cfg = ns.config
    for v in ("PINT_TPU_AOT_DIR", "PINT_TPU_JOURNAL",
              "PINT_TPU_TENANT_BURST"):
        mp.delenv(v, raising=False)
    mp.setenv("PINT_TPU_TENANT_QPS", "12.5")
    out = [cfg.tenant_qps(), cfg.tenant_burst()]
    mp.setenv("PINT_TPU_TENANT_BURST", "4")
    out.append(cfg.tenant_burst())
    mp.delenv("PINT_TPU_TENANT_QPS")
    out.append(cfg.tenant_qps())
    for v in ("reject", "banana"):
        mp.setenv("PINT_TPU_SHED_POLICY", v)
        out.append(cfg.shed_policy())
    mp.delenv("PINT_TPU_SHED_POLICY")
    out += [cfg.shed_policy(), cfg.aot_dir(), cfg.journal_path()]
    mp.setenv("PINT_TPU_AOT_DIR", "/tmp/x")
    mp.setenv("PINT_TPU_JOURNAL", "/tmp/j.jsonl")
    mp.setenv("PINT_TPU_SERVE_DRAIN_TIMEOUT_S", "7")
    out += [cfg.aot_dir(), cfg.journal_path(),
            cfg.serve_drain_timeout_s()]
    # the remaining serve parsers, defaults and overrides
    for v in ("PINT_TPU_SERVE_WINDOW_MS", "PINT_TPU_SERVE_MAX_BATCH",
              "PINT_TPU_SERVE_QUEUE_CAP", "PINT_TPU_SERVE_PIPELINE",
              "PINT_TPU_JOURNAL_COMPACT_BYTES", "PINT_TPU_METRICS_PORT",
              "PINT_TPU_DONATE"):
        mp.delenv(v, raising=False)
    out += [cfg.serve_window_s(), cfg.serve_max_batch(),
            cfg.serve_queue_cap(), cfg.serve_pipeline_depth(),
            cfg.journal_compact_bytes(), cfg.metrics_port(),
            cfg.donation_enabled()]
    for name, val in (("PINT_TPU_SERVE_WINDOW_MS", "2"),
                      ("PINT_TPU_SERVE_MAX_BATCH", "0"),
                      ("PINT_TPU_SERVE_QUEUE_CAP", "16"),
                      ("PINT_TPU_SERVE_PIPELINE", "4"),
                      ("PINT_TPU_JOURNAL_COMPACT_BYTES", "-5"),
                      ("PINT_TPU_METRICS_PORT", "70000"),
                      ("PINT_TPU_DONATE", "off")):
        mp.setenv(name, val)
    out += [cfg.serve_window_s(), cfg.serve_max_batch(),
            cfg.serve_queue_cap(), cfg.serve_pipeline_depth(),
            cfg.journal_compact_bytes(), cfg.metrics_port(),
            cfg.donation_enabled()]
    mp.setenv("PINT_TPU_METRICS_PORT", "0")
    return out + [cfg.metrics_port()]


def s_rtt_env(ns, mp, tmp):
    cfg = ns.config
    mp.delenv("PINT_TPU_DISPATCH_RTT_MS", raising=False)
    measured = cfg.dispatch_rtt_ms()
    mp.setenv("PINT_TPU_DISPATCH_RTT_MS", "123.5")
    over = cfg.dispatch_rtt_ms()
    mp.setenv("PINT_TPU_DISPATCH_RTT_MS", "fast")
    return [measured > 0, over, cfg.dispatch_rtt_ms() == measured,
            ("PINT_TPU_DISPATCH_RTT_MS", "fast") in cfg._WARNED_ENV]


SCENARIOS = {
    "test_compile_count_stays_bounded_under_traffic":
        s_compile_count_bounded,
    "test_backpressure_queue_cap": s_backpressure,
    "test_deadline_expires_in_queue": s_deadline_expires,
    "test_oversize_falls_back_to_single": s_oversize_single,
    "test_oversize_shared_class_coalesces": s_oversize_shared,
    "test_empty_engine_snapshot_is_strict_json": s_empty_snapshot,
    "test_failed_dispatch_does_not_count_a_compile": s_failed_dispatch,
    "test_phase_partial_submit_counts_semaphore_correctly":
        s_phase_partial_submit,
    "test_expired_request_shed_while_queued": s_expired_shed_while_queued,
    "test_tenant_quota_sheds_bursting_tenant": s_tenant_quota,
    "test_deadline_aware_shed_policy": s_deadline_aware,
    "test_shed_policy_wait_is_position_aware": s_position_aware,
    "test_reject_policy_restores_plain_backpressure": s_reject_policy,
    "test_breaker_demotion_routes_to_host_pool": s_breaker_demotion,
    "test_router_steers_by_learned_rates": s_router_steers,
    "test_daemon_startup_shutdown_sheds_pending_stdin":
        s_startup_shutdown,
    "test_serve_bucket_env_knob": s_bucket_env,
    "test_issue8_env_knobs": s_env_knobs,
    "test_rtt_env_read_before_cache": s_rtt_env,
}


def _same(a, b, path="out"):
    """Outcome equality: floats within 1e-6 relative (the two packages'
    models of one pulsar), everything else exactly."""
    if isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6), path
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_shared_semantics(case, ref_zoo, port_zoo, monkeypatch,
                          tmp_path):
    import pint_tpu_torch.runtime as prt
    import pint_tpu.runtime as rrt

    outs = {}
    for which in ("ref", "port"):
        with monkeypatch.context() as mp:
            ns = _ns(which, ref_zoo, port_zoo)
            outs[which] = SCENARIOS[case](ns, mp, tmp_path)
        (rrt if which == "ref" else prt).reset_runtime()
    _same(outs["port"], outs["ref"])


# ----------------------------------------------------------- numerics


def _mixed(S, zoo, entry, problems=None):
    """tests/test_serve.py's mixed request list: a fit step and a
    residuals request per pulsar (prebuilt ``problems`` when given),
    three phase reads."""
    reqs = []
    for k, (m, t) in enumerate(zoo):
        if problems is None:
            reqs += [S.FitStepRequest(t, m), S.ResidualsRequest(t, m)]
        else:
            reqs += [S.FitStepRequest(problem=problems[k]),
                     S.ResidualsRequest(problem=problems[k])]
    for s in range(3):
        mjds = 55000.0 + s + np.linspace(-0.01, 0.01, 16 + 8 * s)
        reqs.append(S.PhasePredictRequest(entry(s), mjds))
    return reqs


def _clone(S, req):
    if isinstance(req, S.PhasePredictRequest):
        return S.PhasePredictRequest(req.entry, req.mjds)
    if req.toas is None:
        return type(req)(problem=req.problem)
    return type(req)(req.toas, req.model)


def _assert_close(a, b, rtol, atol=1e-18):
    if hasattr(a, "phase_int"):
        tot = (np.asarray(a.phase_int) - np.asarray(b.phase_int)) \
            + (np.asarray(a.phase_frac) - np.asarray(b.phase_frac))
        assert np.all(np.abs(tot) < TEN_PS_TURNS)
    elif hasattr(a, "dparams"):
        np.testing.assert_allclose(a.dparams, b.dparams, rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(np.diag(a.cov), np.diag(b.cov),
                                   rtol=rtol)
        assert a.chi2 == pytest.approx(b.chi2, rel=rtol)
        assert a.chi2r == pytest.approx(b.chi2r, rel=rtol)
    else:
        assert a.chi2 == pytest.approx(b.chi2, rel=rtol)


@pytest.fixture(scope="module")
def ref_served(ref_zoo, problems):
    """The reference engine's coalesced results on the shared prebuilt
    problems."""
    import pint_tpu.serve as R

    ns = _ns("ref", ref_zoo, None)
    eng = R.ServeEngine()
    futs = [eng.submit(r) for r in _mixed(
        R, ref_zoo, lambda s: _entry(ns, s), problems)]
    eng.flush()
    return [f.result(timeout=0) for f in futs]


def _port_mixed(port_zoo, problems=None):
    import pint_tpu_torch.serve as S

    ns = _ns("port", None, port_zoo)
    return _mixed(S, port_zoo, lambda s: _entry(ns, s), problems)


def test_coalesced_matches_sequential(port_zoo, problems, ref_served):
    """The acceptance oracle on the port: one coalesced flush == one
    dispatch per request (1e-9 relative), across >= 3 TOA buckets and
    all three request kinds, classes bounded by the class count; and
    on the shared prebuilt problems, the coalesced port engine == the
    reference's (1e-8 relative)."""
    import pint_tpu_torch.serve as S

    reqs = _port_mixed(port_zoo)
    seq = S.ServeEngine(device=CPU)
    seq_res = []
    for r in reqs:
        fut = seq.submit(_clone(S, r))
        seq.flush()
        seq_res.append(fut.result(timeout=0))
    co = S.ServeEngine(device=CPU)
    futs = [co.submit(r) for r in reqs]
    co.flush()
    co_res = [f.result(timeout=0) for f in futs]
    for a, b in zip(co_res, seq_res):
        _assert_close(a, b, 1e-9)
        if hasattr(a, "time_resids"):
            np.testing.assert_array_equal(a.time_resids, b.time_resids)
    snap = co.metrics.snapshot()
    assert snap["completed"] == len(reqs)
    assert len({k[1] for k in co.metrics.buckets if k[0] == "gls"}) >= 3
    assert snap["compile_count"] <= snap["bucket_count"]
    assert snap["compile_count"] < len(reqs)
    assert sum(b.batches for b in co.metrics.buckets.values()) < len(reqs)
    assert co.cache.jit_cache_size() is None
    # every result came from the device pool, none failed over
    assert snap["router"]["host"]["dispatches"] == 0
    assert snap["dispatch"]["failovers"] == 0

    eng = S.ServeEngine(device=CPU)
    futs = [eng.submit(r) for r in _port_mixed(port_zoo, problems)]
    eng.flush()
    for a, b in zip([f.result(timeout=0) for f in futs], ref_served):
        _assert_close(a, b, 1e-8, atol=1e-15)


def test_pipelined_drain_matches_sync(port_zoo, problems, ref_served):
    import pint_tpu_torch.serve as S

    sync = S.ServeEngine(pipeline_depth=1, device=CPU)
    futs = [sync.submit(r) for r in _port_mixed(port_zoo, problems)]
    sync.flush()
    sync_res = [f.result(timeout=0) for f in futs]
    pipe = S.ServeEngine(pipeline_depth=3, device=CPU)
    futs = [pipe.submit(r) for r in _port_mixed(port_zoo, problems)]
    pipe.flush()
    pipe_res = [f.result(timeout=0) for f in futs]
    for a, b, c in zip(pipe_res, sync_res, ref_served):
        _assert_close(a, b, 1e-9)
        _assert_close(a, c, 1e-8, atol=1e-15)
    snap = pipe.metrics.snapshot()
    assert snap["completed"] == len(pipe_res)
    assert snap["pipeline_depth"] == 3
    assert snap["dispatch"]["max_inflight"] >= 2
    assert snap["dispatch"]["async_dispatches"] >= 2
    assert sync.metrics.snapshot()["dispatch"]["async_dispatches"] == 0
    # eager torch has no buffer donation: labeled off
    assert snap["donation"] is False


def test_serve_matches_host_oracles(port_zoo):
    """Served results vs the port's single-pulsar host oracles: fit step
    vs gls._gls_kernel, residuals chi2 vs Residuals.chi2, phase vs
    PolycoEntry.abs_phase (the reference's limits)."""
    import pint_tpu_torch.serve as S
    from pint_tpu_torch.gls import _gls_kernel
    from pint_tpu_torch.parallel.pta import build_problem
    from pint_tpu_torch.residuals import Residuals

    ns = _ns("port", None, port_zoo)
    eng = S.ServeEngine(device=CPU)
    m, t = port_zoo[2]
    mjds = 55000.0 + np.linspace(-0.01, 0.01, 24)
    f_fit = eng.submit(S.FitStepRequest(t, m))
    f_res = eng.submit(S.ResidualsRequest(t, m))
    f_ph = eng.submit(S.PhasePredictRequest(_entry(ns), mjds))
    eng.flush()
    pr = build_problem(t, m)
    x, cov, chi2, _, _, ok = _gls_kernel(*(
        torch.as_tensor(a) for a in (pr.M, pr.F, pr.phi, pr.r, pr.nvec)))
    assert bool(ok)
    rf = f_fit.result(timeout=0)
    np.testing.assert_allclose(rf.dparams, -x.numpy(), rtol=1e-8,
                               atol=1e-15)
    np.testing.assert_allclose(np.diag(rf.cov), np.diag(cov.numpy()),
                               rtol=1e-8)
    assert rf.chi2 == pytest.approx(float(chi2), rel=1e-8)
    rr = f_res.result(timeout=0)
    host = Residuals(t, m)
    assert rr.chi2 == pytest.approx(float(host.chi2), rel=1e-8)
    np.testing.assert_allclose(rr.time_resids,
                               host.time_resids.cpu().numpy(), rtol=0,
                               atol=1e-12)
    rp = f_ph.result(timeout=0)
    pi, pf = _entry(ns).abs_phase(mjds)
    assert np.all(np.abs((rp.phase_int - pi) + (rp.phase_frac - pf))
                  < TEN_PS_TURNS)


def test_threaded_engine_coalesces(port_zoo, problems, ref_served):
    import pint_tpu_torch.serve as S

    eng = S.ServeEngine(window_s=0.05, device=CPU).start()
    try:
        reqs = _port_mixed(port_zoo, problems)
        futs = [eng.submit(r) for r in reqs]
        res = [f.result(timeout=30) for f in futs]
    finally:
        eng.stop()
    for a, b in zip(res, ref_served):
        _assert_close(a, b, 1e-8, atol=1e-15)
    assert eng.metrics.completed == len(futs)
    assert sum(b.batches for b in eng.metrics.buckets.values()) \
        < len(futs)


def test_mesh_refused(port_zoo):
    """The port has no device mesh: ServeEngine, ExecutableCache and
    GWBRequest.ensure_likelihood refuse ``mesh=`` (the reference's
    mesh-engine case)."""
    import pint_tpu_torch.serve as S
    from pint_tpu_torch.serve.bucket import ExecutableCache

    with pytest.raises(NotImplementedError, match="mesh"):
        S.ServeEngine(mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="mesh"):
        ExecutableCache(mesh=object(), device=CPU)
    req = S.GWBRequest(pairs=[p[::-1] for p in port_zoo[:2]],
                       log10A=[-14.0], gamma=[13 / 3])
    with pytest.raises(NotImplementedError, match="mesh"):
        req.ensure_likelihood(mesh=object(), device=CPU)


def test_fitter_auto_serve_route():
    """Fitter.auto(serve=engine) fits through the engine and lands on
    the parameters of the port's direct batched fitter (fit_pta) and
    of the reference's serve route."""
    import copy

    import pint_tpu.serve as R
    from pint_tpu.fitter import Fitter as RFitter
    import pint_tpu_torch.serve as S
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.parallel import fit_pta
    from pint_tpu_torch.serve.scheduler import ServeGLSFitter

    rm, rt = _mk(7, 80)
    m, t = _port_pair(rm, rt)
    m_ref = copy.deepcopy(m)
    eng = S.ServeEngine(device=CPU)
    f = Fitter.auto(t, m, serve=eng)
    assert isinstance(f, ServeGLSFitter)
    chi2 = f.fit_toas(maxiter=3)
    ref = fit_pta([(t, m_ref)], maxiter=3, device=CPU)
    assert chi2 == pytest.approx(ref[0]["chi2"], rel=1e-6)
    for name in m.free_params:
        err = ref[0]["errors"][name]
        assert abs(m.get_param(name).value
                   - m_ref.get_param(name).value) < 1e-6 * err, name
        assert f.errors[name] == pytest.approx(err, rel=1e-6)
    rf = RFitter.auto(rt, rm, serve=R.ServeEngine())
    rchi2 = rf.fit_toas(maxiter=3)
    assert chi2 == pytest.approx(rchi2, rel=1e-6)
    for name in m.free_params:
        err = rf.errors[name]
        assert abs(m.get_param(name).value
                   - rm.get_param(name).value) < 1e-3 * err, name
    with pytest.raises(ValueError, match="exclusive"):
        Fitter.auto(t, m, serve=eng, device=True)


def test_fitter_serve_rejects_wideband():
    import pint_tpu_torch.serve as S
    from pint_tpu_torch.fitter import Fitter

    rm, rt = _mk(8, 40)
    for f in rt.flags:
        f["pp_dm"] = "1.0e-4"
        f["pp_dme"] = "1.0e-5"
    m, t = _port_pair(rm, rt)
    with pytest.raises(ValueError, match="wideband"):
        Fitter.auto(t, m, serve=S.ServeEngine(device=CPU))


def _cli(argv, stdin=None):
    from pint_tpu_torch.scripts.pint_serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--device", CPU] + argv, stdin=stdin) == 0
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()]


def test_daemon_demo_smoke():
    lines = _cli(["--demo", "12", "--window-ms", "2"])
    snap = lines[-1]
    assert snap["metric"] == "serve_session"
    assert len(lines[:-1]) == 12 and all(r["ok"] for r in lines[:-1])
    assert snap["completed"] == 12
    assert snap["compile_count"] <= snap["bucket_count"]


def test_daemon_demo_sheds_overload_instead_of_crashing():
    lines = _cli(["--demo", "12", "--queue-cap", "1", "--window-ms",
                  "60"])
    snap = lines[-1]
    assert snap["metric"] == "serve_session"
    results = lines[:-1]
    assert len(results) == 12
    shed = [r for r in results if not r["ok"]]
    assert all("ServeOverload" in r["error"] for r in shed)
    assert snap["completed"] == 12 - len(shed)
    assert snap["rejected"] == len(shed)


def test_workload_builder_shared_by_bench_and_demo():
    """One workload builder: the port's demo requests are the
    reference's demo mix (the same kinds in the same order), assembled
    at dispatch; the bench form prebuilds problems."""
    from pint_tpu.scripts.pint_serve import _demo_requests as r_demo
    from pint_tpu_torch.scripts.pint_serve import _demo_requests
    from pint_tpu_torch.serve.request import Request
    from pint_tpu_torch.serve.workload import build_workload

    reqs = _demo_requests(9, device=CPU)
    assert [k for k, _ in reqs] == [k for k, _ in r_demo(9)]
    assert {k for k, _ in reqs} == {"fit_step", "residuals", "phase"}
    assert all(isinstance(r, Request) for _, r in reqs)
    assert all(getattr(r, "problem", None) is None for _, r in reqs)
    bench = build_workload(9, sizes=(50, 60), device=CPU)()
    assert len(bench) == 9
    assert any(getattr(r, "problem", None) is not None for r in bench)


def test_daemon_graceful_shutdown_sheds_queued(tmp_path):
    from pint_tpu_torch.scripts.pint_serve import _Shutdown

    par = os.path.join(DATADIR, "NGC6440E.par")
    tim = os.path.join(DATADIR, "NGC6440E.tim")
    jpath = str(tmp_path / "journal.jsonl")

    def feed():
        yield json.dumps({"kind": "fit_step", "par": par, "tim": tim,
                          "id": "a"}) + "\n"
        yield json.dumps({"kind": "residuals", "par": par, "tim": tim,
                          "id": "b"}) + "\n"
        raise _Shutdown("SIGTERM")

    lines = _cli(["--window-ms", "60000", "--drain-timeout-s", "0",
                  "--journal", jpath], stdin=feed())
    snap = lines[-1]
    assert snap["metric"] == "serve_session"
    assert snap["shutdown_signal"] == "SIGTERM"
    shed = [x for x in lines if x.get("status") == "shed"]
    assert sorted(x["id"] for x in shed) == ["a", "b"]
    assert all(x["reason"] == "shutdown" for x in shed)
    assert snap["admission"]["shed_shutdown"] == 2
    acks = [json.loads(x)["status"] for x in open(jpath)
            if json.loads(x)["op"] == "ack"]
    assert acks == ["shed:shutdown", "shed:shutdown"]


# --------------------------------------------- the port's own programs


def test_bucket_helpers_are_the_reference_copy():
    from pint_tpu.serve import bucket as rb
    from pint_tpu_torch.serve import bucket as pb

    edges = (64, 128, 256, 16384)
    for n in (1, 2, 3, 63, 64, 65, 200, 16384, 16385, 10 ** 6):
        assert pb.pow2_ceil(n) == rb.pow2_ceil(n)
        assert pb.bucket_for(n, edges) == rb.bucket_for(n, edges)
        for p, q in ((0, 0), (3, 7), (9, 30), (124, 64)):
            assert pb.pad_dim(p) == rb.pad_dim(p)
            assert pb.gls_shape_class(n, p, q, edges) == \
                rb.gls_shape_class(n, p, q, edges)
            assert pb.append_shape_class(n, p, q, edges) == \
                rb.append_shape_class(n, p, q, edges)
            assert pb.posterior_shape_class(n, p, q, 32, 64, 2, edges) \
                == rb.posterior_shape_class(n, p, q, 32, 64, 2, edges)
        assert pb.phase_shape_class(n, 12, edges) == \
            rb.phase_shape_class(n, 12, edges)
    assert pb.gwb_shape_class(67, 28, 8) == rb.gwb_shape_class(67, 28, 8)


def test_phase_eval_bitwise_reference():
    """The batched _phase_eval_one == the reference's vmapped one run
    op by op (jax.disable_jit): the same IEEE operations."""
    import jax

    from pint_tpu.serve.bucket import _phase_eval_one as r_phase
    from pint_tpu_torch.serve.bucket import _phase_eval_one

    rng = np.random.default_rng(5)
    P, nb, k = 4, 64, 12
    coeffs = rng.normal(size=(P, k)) * 10.0 ** -np.arange(k)
    tmid = 55000.0 + rng.uniform(0, 10, P)
    rpi = np.round(rng.uniform(1e6, 1e10, P))
    rpf = rng.uniform(0, 1, P)
    f0 = rng.uniform(1, 700, P)
    mjds = tmid[:, None] + rng.uniform(-0.02, 0.02, (P, nb))
    valid = (rng.uniform(size=(P, nb)) > 0.2).astype(float)
    args = (coeffs, tmid, rpi, rpf, f0, mjds, valid)
    with jax.disable_jit():
        want = jax.vmap(r_phase)(*args)
    got = _phase_eval_one(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _append_case(P=3, nb=64, p=5, q=6, seed=2):
    rng = np.random.default_rng(seed)
    Pn = p + q
    M = rng.normal(size=(P, nb, p))
    M[:, :, 0] = 1.0
    F = rng.normal(size=(P, nb, q))
    valid = np.ones((P, nb))
    valid[1, 40:] = 0.0
    pvalid = np.ones((P, p))
    pvalid[2, -1] = 0.0
    base = rng.normal(size=(P, 3 * Pn, Pn))
    Sig = np.einsum("kij,kil->kjl", base, base)
    return dict(cm=np.abs(rng.normal(size=(P, p))) + 0.5, Sig=Sig,
                b=rng.normal(size=(P, Pn)), u=rng.normal(size=(P, Pn)),
                scal=np.concatenate([np.abs(rng.normal(size=(P, 3))) * 10,
                                     np.zeros((P, 5))], axis=1),
                M=M, F=F, phi=np.abs(rng.normal(size=(P, q))) + 0.1,
                r0=rng.normal(size=(P, nb)) * 1e-6,
                nvec=np.full((P, nb), 1e-12), valid=valid, pvalid=pvalid,
                submean=np.array([1.0, 0.0, 1.0]),
                cold=np.array([0.0, 1.0, 0.0]))


def test_append_slot_matches_reference_and_mirror():
    """The batched append slot == the reference's compiled vmapped slot
    (1e-9 relative) and == the numpy mirror slot by slot (1e-9)."""
    import jax

    from pint_tpu.serve.append import append_kernel as r_kernel
    from pint_tpu_torch.serve.append import _append_slot, append_slot_np
    from pint_tpu_torch.serve.bucket import APPEND_KEYS

    case = _append_case()
    budget = 8 * (5 + 1)
    got = _append_slot(*(torch.as_tensor(case[k]) for k in APPEND_KEYS),
                       budget, 1e-13)
    want = r_kernel()(*(case[k] for k in APPEND_KEYS),
                      jax.numpy.asarray(np.int32(budget)),
                      jax.numpy.asarray(1e-13))
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if j >= 9:   # ok, iters
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9,
                                       atol=1e-9 * np.max(np.abs(w)))
    for k in range(3):
        ref = append_slot_np(*(case[n][k] for n in APPEND_KEYS),
                             budget=budget)
        for j, (g, w) in enumerate(zip(got, ref)):
            g, w = g[k].numpy(), np.asarray(w)
            if j >= 9:
                assert bool(g) == bool(w) if j == 9 else int(g) == int(w)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=1e-9, atol=1e-9 * np.max(np.abs(w)))


def test_cg_schur_batch_slot_equality():
    """Each slot of the batched CG == ``_cg_schur`` of that slot alone:
    iteration counts exactly, values within 1e-12 relative; and a
    slot's result does not depend on its batch-mates (a slot that
    converges early is frozen while the others iterate)."""
    from pint_tpu_torch.parallel.streaming import _cg_schur, \
        _cg_schur_batch

    rng = np.random.default_rng(9)
    P, p, q = 4, 6, 9
    n = p + q
    mats = []
    for k in range(P):
        base = rng.normal(size=(3 * n, n)) * np.logspace(0, k, n)
        mats.append(base.T @ base + np.eye(n) * 10.0 ** -k)
    # slot 0: a diagonal system, converged after one CG step
    mats[0] = np.diag(rng.uniform(1.0, 2.0, n))
    Sigma = torch.as_tensor(np.stack(mats))
    b = torch.as_tensor(rng.normal(size=(P, n)))
    rCr = torch.as_tensor(np.abs(rng.normal(size=P)) * 100 + 50)
    cm = torch.as_tensor(np.abs(rng.normal(size=(P, p))) + 0.5)
    budget = 8 * (p + 1)
    got = _cg_schur_batch(Sigma, b, rCr, cm, budget, 1e-13)
    for k in range(P):
        one = _cg_schur(Sigma[k], b[k], rCr[k], cm[k], budget, 1e-13)
        assert int(got[6][k]) == one[6]
        assert bool(got[5][k]) == bool(one[5])
        for j in (0, 1, 2, 3, 4, 7):
            w = one[j].numpy()
            np.testing.assert_allclose(
                got[j][k].numpy(), w, rtol=1e-12,
                atol=1e-12 * max(1.0, float(np.max(np.abs(w)))))
    # slot 0 alone in a batch of one == slot 0 of the batch
    solo = _cg_schur_batch(Sigma[:1], b[:1], rCr[:1], cm[:1], budget,
                           1e-13)
    assert int(solo[6][0]) == int(got[6][0])
    np.testing.assert_allclose(solo[0][0].numpy(), got[0][0].numpy(),
                               rtol=1e-12)
    assert len(set(int(i) for i in got[6])) > 1   # slots differ


def test_two_engines_build_problems_at_once(port_zoo):
    """Two engines classifying at the same time on two threads (each
    classify runs the design matrix by torch.func.jacfwd): the
    process-wide design lock serializes them, and every result equals
    the one engine's."""
    import pint_tpu_torch.serve as S

    pairs = list(port_zoo[:4])
    one = S.ServeEngine(device=CPU)
    futs = [one.submit(S.FitStepRequest(t, m)) for m, t in pairs]
    one.flush()
    want = [f.result(timeout=0) for f in futs]

    engines = [S.ServeEngine(device=CPU), S.ServeEngine(device=CPU)]
    results = [None, None]
    errors = []
    barrier = threading.Barrier(2)

    def run(i):
        try:
            barrier.wait()
            fs = [engines[i].submit(S.FitStepRequest(t, m))
                  for m, t in pairs]
            engines[i].flush()
            results[i] = [f.result(timeout=0) for f in fs]
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    for res in results:
        for a, b in zip(res, want):
            np.testing.assert_array_equal(a.dparams, b.dparams)
            assert a.chi2 == b.chi2
