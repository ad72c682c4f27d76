"""The serve layer's request kinds and planes on the port
(pint_tpu_torch.serve), held to the reference on the CPU: the serve cases
of tests/test_streaming_gls.py (append), tests/test_sampling.py
(posterior), tests/test_gwb.py (GWB), tests/test_metrics.py,
tests/test_obs.py, tests/test_health.py, tests/test_perf.py and
tests/test_runtime_faults.py, each run on the port with the reference's
assertions, and compared to the reference where the two packages
compute the same thing.

Tolerances:

- append: the warm append within 1e-7 sigma of the port's own cold
  streaming solve over the combined TOAs and chi2r within 1e-8 relative
  (the reference's limits), and within 1e-6 sigma / 1e-8 relative of the
  reference engine's append on its own models of the same TOAs;
- posterior: the port's random streams are a counter-based hash, not
  ``jax.random``, so chains are held bitwise to the port's direct
  ``sample_problems`` at the same class and seeds, and by their moments
  to the reference's GLS solution of the same problem
  (tests/test_sampling.py's limits);
- GWB: the served grid bitwise the port's ``gwb_sweep_driver`` on the
  same likelihood, and within 1e-8 relative of the reference's
  ``loglik_grid`` on its own models of the same array;
- degraded serving: a failed-over result bitwise the fault-free one
  (posterior, append on the CPU: the host failover runs the same
  programs), GLS chi2 within the reference's 1e-8 relative.
"""

import contextlib
import copy
import io
import json
import os
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest

from pint_tpu_torch import obs
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.obs import metrics as om
from pint_tpu_torch.parallel.pta import PulsarProblem
from pint_tpu_torch.runtime import Fault, FaultPlan, reset_runtime
from pint_tpu_torch.serve import (
    AppendTOAsRequest,
    DeadlineExceeded,
    FitStepRequest,
    GWBRequest,
    PosteriorRequest,
    ResidualsRequest,
    ServeEngine,
    StateMissing,
)
from pint_tpu_torch.serve.workload import build_workload

CPU = "cpu"
DATADIR = os.path.join(os.path.dirname(__file__), "datafile")


@pytest.fixture(autouse=True)
def clean_runtime():
    reset_runtime()
    obs.reset()
    yield
    reset_runtime()
    obs.reset()


def _port(m, *toas):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = get_model(io.StringIO(m.as_parfile()), device=CPU)
    return (pm,) + tuple(toas_from_columns(t, CPU) for t in toas)


def _eng(**kw):
    return ServeEngine(device=CPU, **kw)


def _workload(n, base, sizes=(40, 90)):
    return build_workload(n, sizes=sizes, base=base, prebuild=True,
                          entry_name="KIND", device=CPU)


def _cli(argv, stdin=None):
    from pint_tpu_torch.scripts.pint_serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--device", CPU] + argv, stdin=stdin) == 0
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()]


# ------------------------------------------------------------- append


@pytest.fixture(scope="module")
def append_data():
    from test_streaming_gls import _mk_append

    rm, rt0, rtn = _mk_append()
    return (rm, rt0, rtn), _port(rm, rt0, rtn)


def test_append_rank_update_matches_combined_oracle(append_data):
    from pint_tpu.serve import AppendTOAsRequest as RAppend
    from pint_tpu.serve import ServeEngine as REngine
    from pint_tpu_torch.parallel.streaming import stream_solve_np
    from pint_tpu_torch.serve.append import build_append_rows
    from pint_tpu_torch.toa import merge_TOAs

    (rm, rt0, rtn), (model, toas0, toas_new) = append_data
    eng = _eng()
    r1 = eng.submit(AppendTOAsRequest(
        "psr", toas=toas0, model=model, cold=True)).result(timeout=60)
    assert r1.cold and r1.ntoa_total == toas0.ntoas
    r2 = eng.submit(AppendTOAsRequest(
        "psr", toas=toas_new, model=model)).result(timeout=60)
    assert not r2.cold
    assert r2.ntoa_total == toas0.ntoas + toas_new.ntoas
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        comb = merge_TOAs([toas0, toas_new])
    entry = eng.append_store.get("psr")
    pr = build_append_rows(comb, model, tspan=entry.tspan,
                           tref=entry.tref)
    dpO, covO, chi2O, chi2rO, _, okO, _, _ = stream_solve_np(
        pr.M, pr.F, pr.phi, pr.r, pr.nvec, 512, incoffset=pr.submean)
    assert okO
    sig = np.sqrt(np.abs(np.diag(covO)))
    assert np.max(np.abs(r2.dparams - dpO) / sig) < 1e-7
    assert abs(r2.chi2r - chi2rO) < 1e-8 * abs(chi2rO)
    snap = eng.metrics.snapshot()["append"]
    assert snap["cold_builds"] == 1 and snap["rank_updates"] == 1
    # the reference engine on its own models of the same TOAs
    reng = REngine()
    reng.submit(RAppend("psr", toas=rt0, model=rm,
                        cold=True)).result(timeout=60)
    w2 = reng.submit(RAppend("psr", toas=rtn,
                             model=rm)).result(timeout=60)
    assert r2.names == w2.names and r2.ntoa_total == w2.ntoa_total
    assert np.max(np.abs(r2.dparams - w2.dparams) / sig) < 1e-6
    assert r2.chi2r == pytest.approx(w2.chi2r, rel=1e-8)
    assert r2.cg_iters == pytest.approx(w2.cg_iters, abs=8)


def test_append_state_contracts(append_data):
    from test_streaming_gls import PAR_ECORR
    from test_streaming_gls import _mk as r_mk

    (_, _, _), (model, toas0, toas_new) = append_data
    toas0 = toas0.select(np.arange(toas0.ntoas) < 200)
    eng = _eng()
    with pytest.raises(StateMissing):
        eng.submit(AppendTOAsRequest(
            "ghost", toas=toas_new, model=model)).result(timeout=60)
    with pytest.raises(StateMissing):
        eng.submit(AppendTOAsRequest(
            "ghost", toas=toas_new, model=model,
            cold=False)).result(timeout=60)
    me, te = _port(*r_mk(PAR_ECORR, n=64, clustered=True))
    fut = eng.submit(AppendTOAsRequest("ec", toas=te, model=me,
                                       cold=True))
    with pytest.raises(ValueError, match="ECORR"):
        fut.result(timeout=60)
    r1 = eng.submit(AppendTOAsRequest(
        "dup", toas=toas0, model=model, cold=True)).result(timeout=60)
    assert r1.cold
    r2 = eng.submit(AppendTOAsRequest(
        "dup", toas=toas_new, model=model)).result(timeout=60)
    assert r2.ntoa_total == toas0.ntoas + toas_new.ntoas
    r3 = eng.submit(AppendTOAsRequest(
        "dup", toas=toas0, model=model, cold=True)).result(timeout=60)
    assert r3.cold and r3.ntoa_total == toas0.ntoas


def test_append_chaos_mid_append_failover(append_data):
    """Mid-append death of the device program: the dispatch fails over
    to the numpy mirror, labeled, and the future resolves with the
    fault-free answer (1e-9 relative); the state stays intact."""
    (_, _, _), (model, toas0, toas_new) = append_data
    toas0 = toas0.select(np.arange(toas0.ntoas) < 300)
    clean = _eng()
    clean.submit(AppendTOAsRequest("psr", toas=toas0, model=model,
                                   cold=True)).result(timeout=60)
    want = clean.submit(AppendTOAsRequest(
        "psr", toas=toas_new, model=model)).result(timeout=60)
    eng = _eng()
    r1 = eng.submit(AppendTOAsRequest(
        "psr", toas=toas0, model=model, cold=True)).result(timeout=60)
    assert r1.cold
    before = eng.supervisor.snapshot()["failovers"]
    with FaultPlan([Fault(match="serve.append", kind="error")]).active():
        r2 = eng.submit(AppendTOAsRequest(
            "psr", toas=toas_new, model=model)).result(timeout=120)
    assert not r2.cold
    assert r2.ntoa_total == toas0.ntoas + toas_new.ntoas
    assert eng.supervisor.snapshot()["failovers"] > before
    np.testing.assert_allclose(r2.dparams, want.dparams, rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(want.dparams)))
    assert r2.chi2r == pytest.approx(want.chi2r, rel=1e-9)
    r3 = eng.submit(AppendTOAsRequest(
        "psr", toas=toas_new, model=model)).result(timeout=60)
    assert r3.ntoa_total == r2.ntoa_total + toas_new.ntoas


def test_append_journal_ack(append_data, tmp_path):
    from pint_tpu_torch.serve.journal import RequestJournal

    (_, _, _), (model, toas0, _) = append_data
    j = RequestJournal(str(tmp_path / "j.jsonl"))
    eng = _eng(journal=j)
    fut = eng.submit(AppendTOAsRequest(
        "psr", toas=toas0.select(np.arange(toas0.ntoas) < 200),
        model=model, cold=True, rid="r1",
        payload={"kind": "append", "key": "psr"}))
    fut.result(timeout=60)
    counts = j.counts()
    assert counts["admitted"] == 1 and counts["acked"] == 1


# ---------------------------------------------------------- posterior


@pytest.fixture(scope="module")
def post_problems():
    """tests/test_sampling.py's problems (the reference's assembly), as
    host arrays."""
    from test_sampling import _problems

    return [PulsarProblem(p.M, p.r, p.nvec, p.F, p.phi, p.names)
            for p in _problems(2)]


def test_served_posterior_bit_identical_to_direct(post_problems):
    from pint_tpu_torch import config
    from pint_tpu_torch.sampling import sample_problems
    from pint_tpu_torch.serve.bucket import posterior_shape_class

    W, nsteps, thin = 8, 40, 1
    eng = _eng()
    futs = [eng.submit(PosteriorRequest(
        problem=copy.copy(pr), nwalkers=W, nsteps=nsteps,
        seed=100 + k, thin=thin)) for k, pr in enumerate(post_problems)]
    eng.flush()
    served = [f.result(timeout=0) for f in futs]
    K = config.chain_chunk_steps(nsteps, thin=thin)
    keys = {posterior_shape_class(
        pr.M.shape[0], pr.M.shape[1], pr.F.shape[1], W, K, thin,
        eng.bucket_edges) for pr in post_problems}
    assert len(keys) == 1
    (_, nb, pb, qb, _, _, _), = keys
    direct = sample_problems(post_problems, W, nsteps, seeds=[100, 101],
                             thin=thin, shape=(eng._batch_pad(2), nb,
                                               pb, qb), device=CPU)
    for res, (chain, lnp, acc) in zip(served, direct):
        np.testing.assert_array_equal(res.chain, chain)
        np.testing.assert_array_equal(res.lnprob, lnp)
        assert res.acceptance_fraction == pytest.approx(acc)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == 2
    assert snap["router"]["device"]["rows_per_s"].get("posterior")
    assert snap["compile_count"] == 1


def test_served_posterior_matches_reference_gls(post_problems):
    """A served chain's moments == the reference's GLS solution of the
    same problem (tests/test_sampling.py:387's limits)."""
    from pint_tpu.parallel.pta import pta_solve_np, stack_problems

    pr = post_problems[0]
    res = _eng().submit(PosteriorRequest(
        problem=copy.copy(pr), nwalkers=16, nsteps=600,
        seed=42)).result()
    dparams, cov = pta_solve_np(stack_problems([pr]))[:2]
    sig = np.sqrt(np.diagonal(cov[0]))
    flat = res.chain[200:].reshape(-1, res.chain.shape[-1])
    assert 0.1 < res.acceptance_fraction < 0.95
    assert np.all(np.abs(flat.mean(axis=0) - dparams[0]) < 0.5 * sig)
    ratio = flat.std(axis=0) / sig
    assert np.all((0.5 < ratio) & (ratio < 2.0))


def test_posterior_request_validates(post_problems):
    import pint_tpu.serve as R

    pr = post_problems[0]
    outs = []
    for S in (R, __import__("pint_tpu_torch.serve").serve):
        out = []
        for kw in ({"nwalkers": 7}, {"nsteps": 0},
                   {"nsteps": 10, "thin": 3}):
            with pytest.raises(ValueError) as e:
                S.PosteriorRequest(problem=pr, **kw)
            out.append(str(e.value))
        with pytest.raises(ValueError, match="2\\*ndim") as e:
            S.PosteriorRequest(problem=pr, nwalkers=4).ensure_problem()
        out.append(str(e.value))
        r = S.PosteriorRequest(problem=pr, nwalkers=8, nsteps=100)
        out += [r.walker_steps, r.kind]
        outs.append(out)
    assert outs[0] == outs[1]
    from pint_tpu_torch.sampling import sample_problems
    with pytest.raises(ValueError, match="2\\*ndim"):
        sample_problems([pr], nwalkers=4, nsteps=8, seeds=[1],
                        device=CPU)


def test_posterior_summary_convention(post_problems):
    pr = post_problems[0]
    eng = _eng()
    fut = eng.submit(PosteriorRequest(problem=copy.copy(pr), nwalkers=8,
                                      nsteps=40, seed=5))
    eng.flush()
    res = fut.result(timeout=0)
    s = res.summary()
    assert set(s) == set(pr.names)
    assert s["Offset"]["std"] >= 0
    assert res.flat().shape == (40 * 8, pr.M.shape[1])


def test_posterior_chaos_mid_chain_backend_death(post_problems,
                                                 monkeypatch):
    monkeypatch.setenv("PINT_TPU_CHAIN_CHUNK", "16")

    def submit_all(eng):
        return [eng.submit(PosteriorRequest(
            problem=copy.copy(pr), nwalkers=8, nsteps=48,
            seed=200 + k)) for k, pr in enumerate(post_problems)]

    ref_eng = _eng()
    ref_futs = submit_all(ref_eng)
    ref_eng.flush()
    ref = [f.result(timeout=0) for f in ref_futs]
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "300")
    eng = _eng()
    # chunk 0 survives; every later chunk hangs past its deadline
    with FaultPlan([Fault(match="serve.posterior", kind="hang",
                          seconds=5.0, after=1)]).active():
        futs = submit_all(eng)
        eng.flush()
    assert all(f.done() for f in futs)
    for f, r in zip(futs, ref):
        res = f.result(timeout=0)
        np.testing.assert_array_equal(res.chain, r.chain)
        np.testing.assert_array_equal(res.lnprob, r.lnprob)
        assert res.acceptance_fraction == r.acceptance_fraction
    disp = eng.metrics.snapshot()["dispatch"]
    assert disp["failovers"] >= 1 and disp["timeouts"] >= 1
    assert "DEGRADED" in eng.metrics.report()


def test_posterior_admission_priced_at_posterior_rate(post_problems):
    from test_sampling import _mk as r_mk

    pr = post_problems[0]
    m, t = _port(*r_mk(ntoa=50, seed=77))
    eng = _eng(queue_cap=2, shed_policy="deadline")
    eng.router.seed_rate("device", "gls", 1e6)
    eng.router.seed_rate("device", "posterior", 10.0)
    assert eng.router.predicted_wait_s(1600, kind="posterior") > \
        eng.router.predicted_wait_s(1600, kind="gls")
    filler = eng.submit(ResidualsRequest(t, m))
    post = eng.submit(PosteriorRequest(problem=copy.copy(pr), nwalkers=8,
                                       nsteps=200, deadline_s=30.0))
    fit = eng.submit(FitStepRequest(t, m, deadline_s=30.0))
    assert post.done()
    with pytest.raises(DeadlineExceeded):
        post.result(timeout=0)
    assert eng.admission.shed_deadline == 1
    eng.flush()
    assert fit.result(timeout=0).chi2 > 0
    assert filler.result(timeout=0).chi2 > 0


def test_daemon_posterior_quantizes_walkers():
    par = os.path.join(DATADIR, "NGC6440E.par")
    tim = os.path.join(DATADIR, "NGC6440E.tim")
    recs = [{"kind": "posterior", "id": "q1", "par": par, "tim": tim,
             "nwalkers": 18, "nsteps": 33, "thin": 3, "seed": 2},
            {"kind": "posterior", "id": "q2", "par": par, "tim": tim,
             "nwalkers": 2, "nsteps": 16, "seed": 3}]
    lines = _cli(["--window-ms", "2"],
                 stdin=iter(json.dumps(r) for r in recs))
    res = [x for x in lines if x.get("id") == "q1"]
    assert len(res) == 1 and res[0]["ok"]
    assert res[0]["nsteps"] == 36
    assert "F0" in res[0]["posterior"]
    res2 = [x for x in lines if x.get("id") == "q2"]
    assert len(res2) == 1 and res2[0]["ok"]


def test_posterior_progress_acks_journaled(post_problems, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("PINT_TPU_CHAIN_CHUNK", "16")
    jpath = str(tmp_path / "j.jsonl")
    eng = _eng(journal=jpath)
    fut = eng.submit(PosteriorRequest(
        problem=copy.copy(post_problems[0]), nwalkers=8, nsteps=48,
        seed=1, payload={"kind": "posterior"}))
    eng.flush()
    fut.result(timeout=0)
    recs = [json.loads(x) for x in open(jpath)]
    assert [r["op"] for r in recs] == \
        ["admit", "progress", "progress", "progress", "ack"]
    assert [r["steps"] for r in recs if r["op"] == "progress"] == \
        [16, 32, 48]
    assert recs[-1]["status"] == "served"
    eng.stop()


# ---------------------------------------------------------------- GWB


@pytest.fixture(scope="module")
def gwb_arrays():
    from pint_tpu.pta.gwb import GWBLikelihood as RLike
    from test_gwb import _mk_pair

    ref = [_mk_pair("J0001+21", 101.1, 40, 11, "12:01:00.0", "21:00:00.0"),
           _mk_pair("J0430-10", 317.9, 64, 12, "04:30:00.0", "-10:00:00.0"),
           _mk_pair("J1820+55", 218.5, 50, 13, "18:20:00.0", "55:00:00.0")]
    port = [_port(m, t)[::-1] for t, m in ref]
    return ref, port, RLike(pairs=ref, nfreq=4)


def _grid():
    la = np.linspace(-15.0, -13.5, 6)
    ga = np.linspace(3.0, 5.5, 6)
    LA, GA = np.meshgrid(la, ga)
    return LA.ravel(), GA.ravel()


def test_serve_gwb_request_matches_direct(gwb_arrays):
    from pint_tpu_torch.pta.gwb import gwb_sweep_driver
    from pint_tpu_torch.serve import GWBResult

    _, port, rlike = gwb_arrays
    la, ga = _grid()
    eng = _eng(window_s=0.0, max_batch=4)
    r = GWBRequest(pairs=port, log10A=la, gamma=ga, nfreq=4)
    res = eng.submit(r).result(timeout=120)
    assert isinstance(res, GWBResult)
    from pint_tpu_torch import config

    direct = gwb_sweep_driver(r.likelihood, la, ga,
                              config.gwb_chunk())()
    np.testing.assert_array_equal(res.logL, direct)
    np.testing.assert_allclose(res.logL, rlike.loglik_grid(la, ga),
                               rtol=1e-8)
    assert res.npulsars == 3 and res.nfreq == 4
    assert res.best()["logL"] == np.max(res.logL)
    snap = eng.metrics.snapshot()
    assert any(k.startswith("gwb/") for k in snap["per_bucket"])
    assert snap["completed"] == 1
    assert snap["compile_count"] == 1


def test_serve_gwb_prebuilt_likelihood_and_validation(gwb_arrays):
    from pint_tpu_torch.pta.gwb import GWBLikelihood

    _, port, _ = gwb_arrays
    like = GWBLikelihood(pairs=port, nfreq=4, device=CPU)
    with pytest.raises(ValueError):
        GWBRequest(log10A=[-14.0], gamma=[4.0])
    with pytest.raises(ValueError):
        GWBRequest(likelihood=like, log10A=[-14.0, -13.0], gamma=[4.0])
    res = _eng(window_s=0.0).submit(GWBRequest(
        likelihood=like, log10A=[-14.0], gamma=[4.0])).result(timeout=120)
    np.testing.assert_allclose(res.logL[0], like.loglik(-14.0, 4.0),
                               rtol=1e-12)


# ------------------------------------------------- metrics / exposition


def test_serve_engine_registry_snapshot_parity():
    fresh = _workload(8, base=6100)
    eng = _eng()
    futs = [eng.submit(r) for r in fresh()]
    eng.flush()
    for f in futs:
        f.result(timeout=0)
    snap = eng.metrics.snapshot()
    reg = om.get_registry()
    assert snap["attempts"] == snap["submitted"] == len(futs)
    for name in ("attempts", "submitted", "completed", "rejected",
                 "failed", "deadline_missed", "fallback_single"):
        assert reg.value(f"pint_tpu_serve_{name}_total",
                         scope=eng.metrics.scope) == snap[name], name
    adm = snap["admission"]
    for name in ("shed_expired", "shed_deadline", "shed_quota",
                 "shed_overload", "shed_shutdown", "shed_bursts",
                 "injected_overload"):
        assert reg.value(f"pint_tpu_admission_{name}_total",
                         scope=eng.admission.scope) == adm[name], name
    rt = snap["router"]
    for pool in ("device", "host"):
        for name in ("dispatches", "requests", "rows", "demotions"):
            assert reg.value(f"pint_tpu_router_{name}_total",
                             scope=eng.router.scope,
                             pool=pool) == rt[pool][name], (pool, name)
    reqs = sum(b.requests for b in eng.metrics.buckets.values())
    assert reqs == snap["completed"]
    tot = reg.get("pint_tpu_serve_bucket_requests_total")
    assert sum(v for k, v in tot.series()
               if ("scope", eng.metrics.scope) in k) == reqs
    m = reg.get("pint_tpu_serve_latency_seconds")
    assert sum(h.count for h in m.matching(
        {"scope": eng.metrics.scope, "metric": "e2e"})) == len(futs)
    # the engine's class-count gauge reads the cache live
    assert dict(reg.get("pint_tpu_serve_compile_count").series()) and \
        snap["compile_count"] >= 2


def test_metrics_server_scrape_and_healthz_with_engine_pools():
    eng = _eng()
    fut = eng.submit(_workload(1, base=6200)()[0])
    eng.flush()
    fut.result(timeout=0)

    def _health():
        h = om.default_health()
        h["pools"] = eng.router.health_block()
        return h

    srv = om.MetricsServer(port=0, health_fn=_health).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "pint_tpu_serve_completed_total" in text
        assert "pint_tpu_serve_compile_count" in text
        h = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read().decode())
        assert h["ok"] is True
        # the device pool's breaker is the engine device's ("cpu" here,
        # "cuda:0" on the card)
        assert h["pools"]["device"]["backend"] == "cpu"
        assert h["pools"]["host"]["open"] is False
    finally:
        srv.close()


def test_scrape_never_blocks_on_the_engine_lock():
    fresh = _workload(4, base=6300)
    eng = _eng(pipeline_depth=2, pools=("device", "aux", "host"))
    futs = [eng.submit(r) for r in fresh()]
    eng.flush()
    for f in futs:
        f.result(timeout=0)

    def _health():
        h = om.default_health()
        h["pools"] = eng.router.health_block()
        return h

    srv = om.MetricsServer(port=0, health_fn=_health).start()
    out = {}
    try:
        assert eng._lock.acquire(timeout=5)
        try:
            def scrape():
                base = f"http://127.0.0.1:{srv.port}"
                out["metrics"] = urllib.request.urlopen(
                    base + "/metrics", timeout=10).read().decode()
                out["health"] = json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=10).read().decode())

            th = threading.Thread(target=scrape, daemon=True)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive(), "scrape blocked on the engine lock"
        finally:
            eng._lock.release()
    finally:
        srv.close()
    assert "pint_tpu_serve_completed_total" in out["metrics"]
    assert set(out["health"]["pools"]) == {"device", "aux", "host"}


# ------------------------------------------------------------ tracing


def _chrome(path):
    doc = json.load(open(path, encoding="utf-8"))
    evs = doc["traceEvents"]
    ids = {e["args"]["span"] for e in evs}
    assert [e for e in evs if e["args"].get("parent") is not None
            and e["args"]["parent"] not in ids] == []
    return evs


def test_shed_burst_triggers_flight_dump(tmp_path):
    from pint_tpu_torch.serve.admission import _BURST_N, \
        AdmissionController

    obs.configure(enabled=True, flight_dir=str(tmp_path))
    adm = AdmissionController(policy="reject")
    for _ in range(_BURST_N):
        adm.note_shed("deadline")
    assert adm.shed_bursts == 1
    deadline = time.monotonic() + 5.0
    dumps = []
    while time.monotonic() < deadline:
        dumps = list(tmp_path.glob("flight-*shed_burst*.json"))
        if dumps:
            break
        time.sleep(0.01)
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["extra"]["admission"]["shed_bursts"] == 1


def test_pipelined_drain_span_integrity(tmp_path):
    fresh = _workload(10, base=3300)
    t = obs.configure(enabled=True)
    eng = _eng(pipeline_depth=2)
    futs = [eng.submit(r) for r in fresh()]
    eng.flush()
    for f in futs:
        f.result(timeout=0)
    path = str(tmp_path / "serve.json")
    t.export(path)
    by_name: dict = {}
    for e in _chrome(path):
        by_name.setdefault(e["name"], []).append(e)
    roots = by_name.get("serve.request", [])
    terms = by_name.get("serve.terminal", [])
    assert len(roots) == len(terms) == len(futs)
    assert all(e["args"]["status"] == "served" for e in terms)
    root_by_span = {e["args"]["span"]: e for e in roots}
    for e in terms:
        assert e["args"]["trace"] == \
            root_by_span[e["args"]["parent"]]["args"]["trace"]
    unit_traces = {e["args"]["trace"] for e in by_name.get("serve.unit", [])}
    queues = by_name.get("serve.queue", [])
    assert len(queues) == len(futs)
    for e in queues:
        assert e["args"]["parent"] in root_by_span
        assert e["args"]["unit"] in unit_traces
    assert by_name.get("serve.route") and by_name.get("serve.issue") \
        and by_name.get("serve.collect")
    assert any(n.startswith("dispatch/serve.") for n in by_name)
    assert eng.metrics.snapshot()["dispatch"]["max_inflight"] >= 2


def test_serve_latency_histograms_per_pool_kind_class():
    fresh = _workload(8, base=3500)
    eng = _eng()
    futs = [eng.submit(r) for r in fresh()]
    eng.flush()
    for f in futs:
        f.result(timeout=0)
    lat = eng.metrics.snapshot()["latency"]
    assert lat
    for key, metrics in lat.items():
        pool, kind = key.split("/")[:2]
        assert pool == "device"      # fault-free: every unit on device
        assert kind in ("gls", "phase")
        assert set(metrics) == {"queue_wait", "dispatch_wall", "e2e"}
        assert all(m["count"] >= 1 for m in metrics.values())
    assert sum(m["e2e"]["count"] for m in lat.values()) == len(futs)


def test_shed_requests_get_terminal_spans():
    from pint_tpu_torch.serve.request import TenantOverQuota

    t = obs.configure(enabled=True)
    fresh = _workload(3, base=3700)
    eng = _eng(tenant_qps=0.001, tenant_burst=1.0)
    reqs = fresh()
    for r in reqs:
        r.tenant = "noisy"
    futs, shed_quota = [], 0
    for r in reqs:
        try:
            futs.append(eng.submit(r))
        except TenantOverQuota:
            shed_quota += 1
    assert shed_quota >= 1
    dead = _workload(1, base=3800)()[0]
    dead.deadline_s = 1e-9
    fut = eng.submit(dead)
    time.sleep(0.002)
    eng.flush()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=0)
    for f in futs:
        f.result(timeout=5)
    statuses = [r["args"]["status"] for r in t.records()
                if r["name"] == "serve.terminal"]
    assert statuses.count("shed:quota") == shed_quota
    assert "shed:deadline" in statuses
    assert statuses.count("served") == len(futs)
    assert len(statuses) == len(reqs) + 1


def test_daemon_stats_request_answers_inline(tmp_path):
    journal = str(tmp_path / "j.jsonl")
    lines = _cli(["--journal", journal],
                 stdin=[json.dumps({"kind": "stats", "id": "s1"})])
    stats = [x for x in lines if x.get("kind") == "stats"]
    assert len(stats) == 1
    s = stats[0]
    assert s["ok"] and s["id"] == "s1"
    assert "latency" in s and "dispatch" in s
    assert "obs" in s and "trace" in s["obs"]
    assert '"stats"' not in open(journal, encoding="utf-8").read()


# ------------------------------------------------------ health / perf


def test_snapshot_health_block_when_armed():
    from pint_tpu_torch.obs import health as oh

    mon = oh.configure(enabled=True)
    mon.observe("gls.solve", {"values": [np.array([np.nan])]},
                pool="device", key="gls.solve")
    h = om.default_health()
    assert h["numerics"]["incidents"] == 1 and h["ok"] is False
    snap = _eng().metrics.snapshot()
    assert snap["health"]["incidents"] == 1
    assert snap["health"]["last_incident"]["reason"] == "nonfinite"


def test_snapshot_health_block_absent_when_disarmed(monkeypatch):
    monkeypatch.delenv("PINT_TPU_HEALTH", raising=False)
    monkeypatch.delenv("PINT_TPU_SHADOW_RATE", raising=False)
    assert "health" not in _eng().metrics.snapshot()


def test_serve_unit_health_tap_observes_every_kind(post_problems):
    """Armed, every collected unit is observed under its serve kind
    with zero extra dispatches; clean results give no incident."""
    from pint_tpu_torch.obs import health as oh

    mon = oh.configure(enabled=True)
    eng = _eng()
    futs = [eng.submit(r) for r in _workload(7, base=3900)()]
    futs.append(eng.submit(PosteriorRequest(
        problem=copy.copy(post_problems[0]), nwalkers=8, nsteps=16)))
    eng.flush()
    for f in futs:
        f.result(timeout=0)
    worst = mon.status()["worst"]
    assert {"device/serve.gls", "device/serve.phase",
            "device/serve.posterior"} <= set(worst)
    assert all(v["ok"] for v in worst.values())
    assert mon.status()["incidents"] == 0


def test_aot_restored_classes_land_in_the_compile_ledger(tmp_path):
    from pint_tpu_torch.obs import perf
    from pint_tpu_torch.serve.journal import AotStore

    d = str(tmp_path / "aot")
    store = AotStore(d, device=CPU)
    store.save("gls", (64, 8, 0, 1), ServeEngine,
               [((1, 64, 8), "float64")])
    assert store.exported == 1
    obs.reset()
    reset_runtime()
    store2 = AotStore(d, device=CPU)
    assert store2.restore_all(primers={"gls": lambda avals: len}) == 1
    snap = perf.get_ledger().snapshot()
    restored = {k: e for k, e in snap["entries"].items()
                if e.get("aot_restored")}
    assert list(restored) == ["serve.gls/64/8/0/1"]
    assert snap["aot_restored"] == 1
    perf.note_compile("serve.gls/64/8/0/1", compile_wall_s=0.25)
    snap = perf.get_ledger().snapshot()
    assert snap["compiles"] == 1
    e = snap["entries"]["serve.gls/64/8/0/1"]
    assert e["aot_restored"] is True and e["compile_wall_s"] == 0.25


def test_serve_snapshot_carries_the_scoreboard_block():
    from pint_tpu_torch.profiling import annotate
    from pint_tpu_torch.serve.metrics import ServeMetrics

    with annotate("unit.region"):
        pass
    assert "unit.region" in ServeMetrics().snapshot().get("scoreboard", {})


# ---------------------------------------------------- degraded serving


def test_serve_drain_completes_every_future_under_backend_death(
        monkeypatch):
    fresh = _workload(12, base=1700, sizes=(40, 90, 150))
    ref_eng = _eng()
    ref_futs = [ref_eng.submit(r) for r in fresh()]
    ref_eng.flush()
    ref_res = [f.result(timeout=0) for f in ref_futs]
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "250")
    eng = _eng()
    with FaultPlan([Fault(match="serve.", kind="hang", seconds=5.0,
                          after=1)]).active():
        futs = [eng.submit(r) for r in fresh()]
        eng.flush()
    assert all(f.done() for f in futs)
    for a, b in zip([f.result(timeout=0) for f in futs], ref_res):
        if hasattr(a, "phase_int"):
            tot = (a.phase_int - b.phase_int) + (a.phase_frac - b.phase_frac)
            assert np.all(np.abs(tot) < 1e-9)
        else:
            assert a.chi2 == pytest.approx(b.chi2, rel=1e-8)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == len(futs)
    assert snap["dispatch"]["failovers"] >= 1
    assert snap["dispatch"]["timeouts"] >= 1
    assert "DEGRADED" in eng.metrics.report()


def test_chaos_overload_tenant_burst_backend_death(monkeypatch,
                                                   tmp_path):
    from pint_tpu_torch.serve import ServeOverload
    from pint_tpu_torch.serve.request import TenantOverQuota

    fresh = _workload(12, base=2700)
    ref_eng = _eng()
    ref_futs = [ref_eng.submit(r) for r in fresh()]
    ref_eng.flush()
    ref_res = [f.result(timeout=0) for f in ref_futs]
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "250")
    tracer = obs.configure(enabled=True)
    eng = _eng()
    plan = FaultPlan([
        Fault(match="serve.gls", kind="hang", seconds=5.0, after=1),
        Fault(match="serve.admit/noisy", kind="tenant_burst"),
        Fault(match="serve.admit/capacity", kind="overload", after=6,
              count=2)])
    reqs = fresh()
    for i, r in enumerate(reqs):
        if i % 6 == 5:
            r.tenant = "noisy"
    shed_quota = shed_overload = 0
    futs = []
    t0 = time.monotonic()
    with plan.active():
        for r in reqs:
            try:
                futs.append((r, eng.submit(r)))
            except TenantOverQuota:
                shed_quota += 1
            except ServeOverload:
                shed_overload += 1
        eng.flush()
    assert time.monotonic() - t0 < 4.0
    assert all(f.done() for _, f in futs)
    ref_by_idx = {id(r): res for r, res in zip(reqs, ref_res)}
    for r, f in futs:
        res, ref = f.result(timeout=0), ref_by_idx[id(r)]
        if hasattr(res, "phase_int"):
            tot = (res.phase_int - ref.phase_int) \
                + (res.phase_frac - ref.phase_frac)
            assert np.all(np.abs(tot) < 1e-9)
        else:
            assert res.chi2 == pytest.approx(ref.chi2, rel=1e-8)
    served = len(futs)
    assert served + shed_quota + shed_overload == len(reqs)
    assert shed_quota >= 1 and shed_overload >= 1
    snap = eng.metrics.snapshot()
    assert snap["completed"] == served
    adm = snap["admission"]
    assert adm["shed_quota"] == shed_quota
    assert adm["injected_overload"] == 2
    assert adm["tenants"]["noisy"]["shed"] == shed_quota
    assert snap["dispatch"]["failovers"] >= 1
    assert snap["dispatch"]["timeouts"] >= 1
    report = eng.metrics.report()
    assert "DEGRADED" in report and "SHED" in report
    path = str(tmp_path / "chaos_trace.json")
    tracer.export(path)
    evs = _chrome(path)
    terms = [e for e in evs if e["name"] == "serve.terminal"]
    assert len(terms) == len(reqs)
    statuses = [e["args"]["status"] for e in terms]
    assert statuses.count("served") == served
    assert statuses.count("shed:quota") == shed_quota
    assert statuses.count("shed:overload") == shed_overload
    names = {e["name"] for e in evs}
    assert "dispatch.failover" in names and "dispatch.timeout" in names
