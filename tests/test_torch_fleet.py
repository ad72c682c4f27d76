"""The serve fleet of the port (pint_tpu_torch.serve.fleet, the N-pool
router and the journal's ownership protocol) held to the reference on the
CPU: the 10 cases of tests/test_fleet.py and the fleet chaos case of
tests/test_runtime_faults.py.

The router, the journal and the fleet front are host code copied from
the reference: the config, router and journal cases run through both
packages and compare outcomes exactly (``test_shared_semantics``). The
fleet cases drive the port's front by hand (engines in sync mode, manual
sweeps) on the reference's prebuilt problems, and hold each served result
to the reference engine's on the same problem within 1e-8 relative (the
batch solve's limit, tests/test_torch_pta.py), and bitwise to a single
port engine where the reference asserts bit-identity.
"""

import json
import time
import types

import numpy as np
import pytest

import pint_tpu.runtime as rrt
import pint_tpu_torch.runtime as prt
from pint_tpu_torch import obs
from pint_tpu_torch.runtime import Fault, FaultPlan
from pint_tpu_torch.serve import (
    EngineKilled,
    FitStepRequest,
    FleetFront,
    ServeEngine,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def clean_runtime():
    rrt.reset_runtime()
    prt.reset_runtime()
    yield
    rrt.reset_runtime()
    prt.reset_runtime()
    obs.reset()


@pytest.fixture(scope="module")
def stock():
    from pint_tpu.parallel.pta import build_problem
    from pint_tpu.serve.workload import synth_pulsar

    pulsars = {k: synth_pulsar(k, 40, base=4300) for k in (0, 1)}
    return {k: build_problem(t, m) for k, (m, t) in pulsars.items()}


@pytest.fixture(scope="module")
def ref_results(stock):
    """The reference engine's fit step of each stock problem."""
    import pint_tpu.serve as R

    eng = R.ServeEngine()
    out = {}
    for k in (0, 1):
        f = eng.submit(R.FitStepRequest(problem=stock[k]))
        eng.flush()
        out[k] = f.result(timeout=0)
    return out


def _factory(stock):
    def factory(payload):
        return FitStepRequest(problem=stock[payload["k"]],
                              payload=payload)

    return factory


def _fit(stock, k):
    return FitStepRequest(problem=stock[k], payload={"k": k})


def _front(stock, tmp_path, n=2, **kw):
    kw.setdefault("heartbeat_s", 3600.0)
    kw.setdefault("lease_ttl_s", 7200.0)
    return FleetFront(_factory(stock), n=n,
                      journal=str(tmp_path / "fleet.jsonl"),
                      start=False, engine_kwargs={"device": CPU}, **kw)


def _close(res, ref):
    np.testing.assert_allclose(res.dparams, ref.dparams, rtol=1e-8,
                               atol=1e-15)
    assert res.chi2 == pytest.approx(ref.chi2, rel=1e-8)


# ------------------------------------------ shared (host-code) scenarios


def _ns(which):
    if which == "ref":
        import pint_tpu.config as config
        from pint_tpu.serve import WorkerLease
        from pint_tpu.serve.journal import RequestJournal
        from pint_tpu.serve.router import CapacityRouter
    else:
        import pint_tpu_torch.config as config
        from pint_tpu_torch.serve import WorkerLease
        from pint_tpu_torch.serve.journal import RequestJournal
        from pint_tpu_torch.serve.router import CapacityRouter
    return types.SimpleNamespace(name=which, config=config,
                                 Lease=WorkerLease,
                                 Journal=RequestJournal,
                                 Router=CapacityRouter)


class _FakeSup:
    """Deterministic pool_health stand-in: breaker state per pool by
    fiat (the port's surface also takes the engine's device)."""

    def __init__(self, open_pools=()):
        self.open_pools = set(open_pools)

    def pool_health(self, pools=None, device=None):
        out = {"device": {"backend": "cpu",
                          "open": "device" in self.open_pools,
                          "inflight": 0},
               "host": {"backend": "cpu", "open": False}}
        for name in pools or ():
            out[name] = {"backend": f"pool:{name}",
                         "open": name in self.open_pools,
                         "inflight": 0}
        return out


def s_config_parsers(ns, mp, tmp):
    cfg = ns.config
    out = []
    mp.delenv("PINT_TPU_POOLS", raising=False)
    out.append(cfg.pool_spec())
    for v in ("device,aux,host", "device,aux", "device,AUX,host",
              "device,host,device"):
        mp.setenv("PINT_TPU_POOLS", v)
        out.append(cfg.pool_spec())
    for v in ("nope", "6"):
        mp.setenv("PINT_TPU_FLEET_LEASE_TTL_S", v)
        out.append(cfg.fleet_lease_ttl_s())
    for v in ("10", "1.5"):
        mp.setenv("PINT_TPU_FLEET_HEARTBEAT_S", v)
        out.append(cfg.fleet_heartbeat_s())
    for v in ("-2", "5"):
        mp.setenv("PINT_TPU_FLEET_WORKERS", v)
        out.append(cfg.fleet_workers())
    return out


def s_router_n_pools(ns, mp, tmp):
    sup = _FakeSup()
    r = ns.Router(supervisor=sup, pools=("device", "aux", "host"))
    out = [r._order, r.pick("gls", 100)]
    r.seed_rate("aux", "gls", 1e12)
    out.append(r.pick("gls", 100))
    sup.open_pools = {"aux"}
    out.append(r.pick("gls", 100))
    sup.open_pools = {"device", "aux"}
    out += [r.pick("gls", 100), r.pools["host"].demotions]
    r.issued("aux", nreq=2, rows=64, kind="gls")
    r.finished("aux", "gls", rows=64, wall_s=0.01)
    snap = r.snapshot()
    return out + [snap["aux"]["dispatches"], snap["aux"]["rows"],
                  snap["aux"]["rows_per_s"]]


def s_router_health_block(ns, mp, tmp):
    r = ns.Router(supervisor=_FakeSup(open_pools={"aux"}),
                  pools=("device", "aux", "host"))
    r.seed_rate("device", "gls", 1000.0)
    r.issued("device", nreq=1, rows=8, kind="gls")
    h = r.health_block()
    return [sorted(h), h["aux"]["open"], h["device"]["open"],
            h["device"]["rows_per_s"], h["device"]["inflight_rows"],
            h["host"]["inflight_rows"]]


def s_journal_ownership(ns, mp, tmp):
    jpath = str(tmp / f"{ns.name}.jsonl")
    j = ns.Journal(jpath)
    lease = ns.Lease(j, "w0", heartbeat_s=3600.0)
    ns.Lease(j, "w1", heartbeat_s=3600.0)
    t0 = j.workers()["w0"]
    time.sleep(0.01)
    lease.beat()
    beats = j.workers()
    out = [sorted(beats), beats["w0"] > t0]
    j.admit("r1", {"k": 0}, worker="w0")
    j.admit("r2", {"k": 1}, worker="w1")
    j.admit("r3", {"k": 0})
    out += [[r["rid"] for r in j.unacknowledged()],
            [r["rid"] for r in j.unacknowledged(owner="w0")]]
    j.rehome("r1", "w1")
    out += [[r["rid"] for r in j.unacknowledged(owner="w1")],
            j.unacknowledged(owner="w0")]
    counts = j.counts()
    out += [counts["workers"], counts["torn"]]
    j.compact()
    out += [j.counts()["compactions"], sorted(j.workers()),
            [r["rid"] for r in j.unacknowledged(owner="w1")]]
    j.close()
    j2 = ns.Journal(jpath)
    out += [sorted(j2.workers()),
            [r["rid"] for r in j2.unacknowledged(owner="w1")]]
    j2.close()
    return out


def s_journal_torn(ns, mp, tmp):
    jpath = str(tmp / f"{ns.name}.jsonl")
    j = ns.Journal(jpath)
    j.admit("r1", {"k": 0}, worker="w0")
    j.admit("r2", {"k": 1})
    j.ack("r2", "served")
    j.close()
    with open(jpath, "r+") as fh:
        lines = fh.read().splitlines()
        fh.seek(0)
        lines.insert(1, '{"op": "admit", "rid": "half')
        lines.insert(2, "[1, 2, 3]")
        fh.write("\n".join(lines) + "\n")
        fh.write('{"op": "ack", "rid": "r1", "sta')
    j2 = ns.Journal(jpath)
    out = [[r["rid"] for r in j2.unacknowledged()], j2.counts()["torn"]]
    j2.unacknowledged()
    out.append(j2.counts()["torn"])
    j2.compact()
    out.append(sorted({json.loads(x)["op"] for x in open(jpath)}))
    j2.close()
    j3 = ns.Journal(jpath)
    out += [[r["rid"] for r in j3.unacknowledged()], j3.counts()["torn"]]
    j3.close()
    return out


SCENARIOS = {
    "test_fleet_config_parsers": s_config_parsers,
    "test_router_n_pools_order_and_pick": s_router_n_pools,
    "test_router_health_block_shape": s_router_health_block,
    "test_journal_ownership_protocol": s_journal_ownership,
    "test_journal_torn_records_warn_and_skip": s_journal_torn,
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_shared_semantics(case, monkeypatch, tmp_path):
    outs = {}
    for which in ("ref", "port"):
        with monkeypatch.context() as mp:
            outs[which] = SCENARIOS[case](_ns(which), mp, tmp_path)
    assert outs["port"] == outs["ref"]


def test_router_device_pool_breaker_is_the_engine_device():
    """The device pool's breaker is the engine device's: "cpu" for a CPU
    engine, "cuda:0" for the card (the breaker keys decided for the
    supervisor); opening it demotes only that engine's device pool."""
    from pint_tpu_torch.runtime import breaker_for

    eng = ServeEngine(device=CPU)
    h = eng.router.health_block()
    assert h["device"]["backend"] == "cpu" and h["host"]["open"] is False
    assert eng.router.pick("gls", 64) == "device"
    br = breaker_for("cpu")
    for _ in range(br.threshold):
        br.on_result(False)
    assert eng.router.pick("gls", 64) == "host"
    sup = prt.DispatchSupervisor()
    assert sup.pool_health(device="cuda:0")["device"]["backend"] == \
        "cuda:0"
    assert sup.pool_health(device="cuda:0")["device"]["open"] is False


# ----------------------------------------------------------------- fleet


def test_fleet_kill_worker_rehomes_onto_survivor(stock, tmp_path,
                                                 ref_results):
    front = _front(stock, tmp_path, n=2)
    f0 = front.submit(_fit(stock, 0))
    f1 = front.submit(_fit(stock, 1))
    assert front.live_workers() == ["w0", "w1"]
    assert front.journal.counts()["unacknowledged"] == 2
    front.kill_worker("w0")
    assert front.live_workers() == ["w1"]
    assert not f0.done()
    with pytest.raises(EngineKilled):
        front.workers["w0"].engine.submit(_fit(stock, 0))
    assert front.sweep() == 1
    snap = front.snapshot()
    assert snap["workers"] == {"w0": "rehomed", "w1": "live"}
    assert snap["counters"]["worker_kills"] == 1
    assert snap["counters"]["rehomed"] == 1
    assert front.sweep() == 0
    front.workers["w1"].engine.flush()
    _close(f0.result(timeout=30), ref_results[0])
    _close(f1.result(timeout=30), ref_results[1])
    assert front.journal.counts()["unacknowledged"] == 0
    f2 = front.submit(_fit(stock, 0))
    front.workers["w1"].engine.flush()
    _close(f2.result(timeout=30), ref_results[0])
    front.stop()


def test_fleet_lease_expiry_fault_and_outage(stock, tmp_path,
                                             ref_results):
    front = _front(stock, tmp_path, n=2)
    f0 = front.submit(_fit(stock, 0))
    with FaultPlan([Fault(match="fleet.lease/w0",
                          kind="lease_expire")]).active():
        assert front.sweep() == 1
    assert front.live_workers() == ["w1"]
    assert front.snapshot()["counters"]["lease_expiries"] == 1
    front.workers["w1"].engine.flush()
    _close(f0.result(timeout=30), ref_results[0])
    assert front.sweep(now=time.time() + 1e6) == 0
    assert front.live_workers() == []
    with pytest.raises(EngineKilled, match="no live workers"):
        front.submit(_fit(stock, 0))
    front.stop()


def test_fleet_metrics_view_and_health_blocks(stock, tmp_path):
    front = _front(stock, tmp_path, n=2)
    f0 = front.submit(_fit(stock, 0))
    front.workers["w0"].engine.flush()
    f0.result(timeout=30)
    snap = front.metrics.snapshot()
    assert set(snap["workers"]) == {"w0", "w1"}
    assert snap["submitted"] == 1
    assert snap["fleet"]["live"] == ["w0", "w1"]
    assert snap["fleet"]["journal"]["unacknowledged"] == 0
    assert isinstance(front.metrics.restart_info, dict)
    assert "[w0]" in front.metrics.report()
    blocks = front.health_blocks()
    assert set(blocks) == {"w0", "w1"}
    assert set(blocks["w0"]) >= {"device", "host"}
    front.stop()


def test_fleet_single_worker_fault_free_matches_engine(stock, tmp_path,
                                                       ref_results):
    front = _front(stock, tmp_path, n=1)
    futs = [front.submit(_fit(stock, k)) for k in (0, 1)]
    front.workers["w0"].engine.flush()
    got = [f.result(timeout=30) for f in futs]
    eng = ServeEngine(device=CPU)
    refs = [eng.submit(FitStepRequest(problem=stock[k])) for k in (0, 1)]
    eng.flush()
    ref = [f.result(timeout=0) for f in refs]
    eng.stop()
    for k, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a.dparams, b.dparams)
        np.testing.assert_array_equal(a.cov, b.cov)
        assert a.chi2 == b.chi2
        _close(a, ref_results[k])
    snap = front.snapshot()
    assert snap["counters"] == \
        {"rehomed": 0, "lease_expiries": 0, "worker_kills": 0}
    assert snap["workers"] == {"w0": "live"}
    front.stop()


def test_fleet_requires_a_journal(stock, monkeypatch):
    monkeypatch.delenv("PINT_TPU_JOURNAL", raising=False)
    with pytest.raises(ValueError, match="replicated log"):
        FleetFront(_factory(stock), n=2, journal=None, start=False)


def test_fleet_chaos_worker_kill_mid_burst(stock, tmp_path,
                                           ref_results):
    """tests/test_runtime_faults.py's fleet chaos oracle on the port:
    three workers, a seeded worker_kill mid-burst, zero lost requests,
    and a trace in which every request root resolves to exactly one
    served terminal with zero orphan spans."""
    tracer = obs.configure(enabled=True)
    front = FleetFront(_factory(stock), n=3,
                       journal=str(tmp_path / "fleet.jsonl"),
                       heartbeat_s=3600.0, lease_ttl_s=7200.0,
                       start=False, engine_kwargs={"device": CPU})
    plan = FaultPlan([Fault(match="fleet.worker/w1", kind="worker_kill",
                            after=6)])
    reqs = [FitStepRequest(problem=stock[i % 2], payload={"k": i % 2})
            for i in range(12)]
    with plan.active():
        futs = [front.submit(r) for r in reqs]
    assert front.live_workers() == ["w0", "w2"]
    assert front.snapshot()["counters"]["worker_kills"] == 1
    assert front.sweep() == 2
    for wid in ("w0", "w2"):
        front.workers[wid].engine.flush()
    assert all(f.done() for f in futs)
    for r, f in zip(reqs, futs):
        _close(f.result(timeout=0), ref_results[r.payload["k"]])
    assert front.journal.counts()["unacknowledged"] == 0
    snap = front.snapshot()
    assert snap["workers"] == {"w0": "live", "w1": "rehomed",
                               "w2": "live"}
    assert snap["counters"]["rehomed"] == 2
    path = str(tmp_path / "fleet_trace.json")
    tracer.export(path)
    evs = json.load(open(path, encoding="utf-8"))["traceEvents"]
    ids = {e["args"]["span"] for e in evs}
    assert [e for e in evs if e["args"].get("parent") is not None
            and e["args"]["parent"] not in ids] == []
    roots = {e["args"]["span"] for e in evs
             if e["name"] == "serve.request"}
    terms = [e for e in evs if e["name"] == "serve.terminal"]
    assert len(terms) == len(roots) == len(reqs) + 2
    assert len({e["args"]["parent"] for e in terms}) == len(terms)
    assert all(e["args"]["status"] == "served" for e in terms)
    assert "fleet.rehome" in {e["name"] for e in evs}
    front.stop()
