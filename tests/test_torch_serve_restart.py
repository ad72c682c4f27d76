"""Crash-safe restart of the port's serve layer (pint_tpu_torch.serve.journal
and the engine's replay) held to the reference on the CPU: the 9 cases of
tests/test_serve_restart.py.

The restart oracle is the reference's: a killed-and-restarted engine
replays the unacknowledged journal entries BITWISE equal to an
uninterrupted engine (same classes, same batch pads, same programs), and
a warm restart serves its first requests with no new class. The port's
``AotStore`` records each class's input shapes (eager torch has no
compiled program to serialize) and primes them at construction, so "no
new compile" reads here as ``compile_count == 0`` on the restarted
engine, with every class lookup a store hit. Both packages' engines serve
the SAME prebuilt problems (the reference's assembly), and the port's
results are held to the reference's within 1e-8 relative (the batch
solve's limit, tests/test_torch_pta.py). The journal is host code copied
from the reference: its cases run through both packages and compare
outcomes exactly.
"""

import contextlib
import io
import json
import os
import types

import numpy as np
import pytest

import pint_tpu.runtime as rrt
import pint_tpu_torch.runtime as prt
from pint_tpu_torch.runtime import Fault, FaultPlan
from pint_tpu_torch.serve import (
    EngineKilled,
    FitStepRequest,
    PhasePredictRequest,
    ServeEngine,
)
from pint_tpu_torch.serve.journal import AotStore, RequestJournal

CPU = "cpu"


@pytest.fixture(autouse=True)
def clean_runtime():
    rrt.reset_runtime()
    prt.reset_runtime()
    yield
    rrt.reset_runtime()
    prt.reset_runtime()


@pytest.fixture(scope="module")
def stock():
    """tests/test_serve_restart.py's stock: two small pulsars (the
    reference's prebuilt problems, shared by both packages) and one
    polyco entry per package."""
    from pint_tpu.parallel.pta import build_problem
    from pint_tpu.serve.workload import demo_polyco_entry as r_entry
    from pint_tpu.serve.workload import synth_pulsar
    from pint_tpu_torch.serve.workload import demo_polyco_entry

    pulsars = {k: synth_pulsar(k, 40, base=3100) for k in (0, 1)}
    return {"entry": demo_polyco_entry("RESTART"),
            "r_entry": r_entry("RESTART"),
            "problems": {k: build_problem(t, m)
                         for k, (m, t) in pulsars.items()}}


def _mk_batch(stock, S=None, entry="entry"):
    import pint_tpu_torch.serve as P

    S = S or P
    mjds = (55000.0 + np.linspace(-0.01, 0.01, 24)).tolist()
    return [
        S.PhasePredictRequest(stock[entry], np.asarray(mjds),
                              payload={"kind": "phase", "mjds": mjds}),
        S.FitStepRequest(problem=stock["problems"][0],
                         payload={"kind": "fit", "k": 0}),
        S.FitStepRequest(problem=stock["problems"][1],
                         payload={"kind": "fit", "k": 1}),
    ]


def _factory(stock):
    def factory(payload):
        if payload["kind"] == "phase":
            return PhasePredictRequest(
                stock["entry"], np.asarray(payload["mjds"]),
                payload=payload)
        return FitStepRequest(
            problem=stock["problems"][payload["k"]], payload=payload)

    return factory


def _assert_bitwise(a, b):
    if hasattr(a, "phase_int"):
        np.testing.assert_array_equal(a.phase_int, b.phase_int)
        np.testing.assert_array_equal(a.phase_frac, b.phase_frac)
    else:
        np.testing.assert_array_equal(a.dparams, b.dparams)
        np.testing.assert_array_equal(a.cov, b.cov)
        assert a.chi2 == b.chi2 and a.chi2r == b.chi2r


def _assert_matches_reference(a, b):
    if hasattr(a, "phase_int"):
        tot = (a.phase_int - b.phase_int) + (a.phase_frac - b.phase_frac)
        assert np.all(np.abs(tot) < 2e-9)   # 10 ps at F0 = 200 Hz
    else:
        np.testing.assert_allclose(a.dparams, b.dparams, rtol=1e-8,
                                   atol=1e-15)
        np.testing.assert_allclose(np.diag(a.cov), np.diag(b.cov),
                                   rtol=1e-8)
        assert a.chi2 == pytest.approx(b.chi2, rel=1e-8)


@pytest.fixture(scope="module")
def ref_batch_results(stock):
    """The reference's uninterrupted engine on the same batch."""
    import pint_tpu.serve as R

    eng = R.ServeEngine()
    futs = [eng.submit(r) for r in _mk_batch(stock, R, "r_entry")]
    eng.flush()
    return [f.result(timeout=0) for f in futs]


def test_kill_restart_replay_bit_identical_and_warm(tmp_path, stock,
                                                    ref_batch_results):
    aot = str(tmp_path / "aot")
    jpath = str(tmp_path / "journal.jsonl")
    eng_b = ServeEngine(aot_dir=aot, journal=jpath, device=CPU)
    b1 = [eng_b.submit(r) for r in _mk_batch(stock)]
    eng_b.flush()
    for f in b1:
        f.result(timeout=0)
    assert eng_b.cache.aot.exported == 2  # phase + gls classes
    b2 = [eng_b.submit(r) for r in _mk_batch(stock)]
    with FaultPlan([Fault(match="serve.drain",
                          kind="kill_restart")]).active():
        with pytest.raises(EngineKilled):
            eng_b.flush()
    assert all(not f.done() for f in b2)
    assert eng_b.journal.counts()["unacknowledged"] == 3
    with pytest.raises(EngineKilled):
        eng_b.submit(_mk_batch(stock)[0])

    eng_r = ServeEngine(device=CPU)
    r1 = [eng_r.submit(r) for r in _mk_batch(stock)]
    eng_r.flush()
    for f in r1:
        f.result(timeout=0)
    r2 = [eng_r.submit(r) for r in _mk_batch(stock)]
    eng_r.flush()
    ref = [f.result(timeout=0) for f in r2]

    eng_c = ServeEngine(aot_dir=aot, journal=jpath, device=CPU)
    assert eng_c.metrics.restart_info["warm"] is True
    assert eng_c.cache.aot.restored == 2
    futs = eng_c.replay(_factory(stock))
    assert len(futs) == 3
    eng_c.flush()
    res = [f.result(timeout=0) for f in futs]
    # no new class: every class lookup was a store hit
    assert eng_c.metrics.compile_count == 0
    assert eng_c.cache.aot.hits == 2 and eng_c.cache.aot.misses == 0
    assert eng_c.cache.jit_cache_size() is None
    for a, b, c in zip(res, ref, ref_batch_results):
        _assert_bitwise(a, b)
        _assert_matches_reference(a, c)
    assert eng_c.journal.counts()["unacknowledged"] == 0
    snap = eng_c.metrics.snapshot()
    assert snap["restart"]["replayed"] == 3
    assert snap["restart"]["aot"]["restored"] == 2
    assert snap["router"]["device"]["dispatches"] == 2
    assert "restart: warm=True" in eng_c.metrics.report()


def test_state_snapshot_written_on_stop(tmp_path, stock):
    from pint_tpu_torch.serve.journal import load_state

    aot = str(tmp_path / "aot")
    eng = ServeEngine(aot_dir=aot, device=CPU)
    fut = eng.submit(FitStepRequest(problem=stock["problems"][0]))
    eng.flush()
    fut.result(timeout=0)
    eng.stop()
    state = load_state(aot)
    assert state is not None and state["reason"] == "shutdown"
    assert state["metrics"]["completed"] == 1
    eng2 = ServeEngine(aot_dir=aot, device=CPU)
    assert eng2.metrics.restart_info["prior_shutdown"] == "shutdown"
    assert eng2.metrics.restart_info["warm"] is True


def test_aot_store_skips_foreign_configuration(tmp_path):
    """The reference's foreign entry (a jax/TPU manifest) and an entry
    of another card are skipped, never primed; a matching one is."""
    import torch

    from pint_tpu_torch.serve.journal import _fingerprint

    d = str(tmp_path / "aot")
    store = AotStore(d, donation=False, device=CPU)
    own = dict(_fingerprint(CPU))
    store._write_manifest({
        "gls/64/8/0/1": {
            "kind": "gls", "key": [64, 8, 0, 1], "file": "missing.bin",
            "avals": [[[1, 4], "float64"]], "donation": False,
            "jax": "0.0.1", "platform": "tpu", "x64": True},
        "gls/64/8/0/2": {
            "kind": "gls", "key": [64, 8, 0, 2],
            "avals": [[[2, 64, 8], "float64"]], "donation": False,
            **dict(own, device="NVIDIA H100 80GB HBM3")},
        "phase/64/4/1": {
            "kind": "phase", "key": [64, 4, 1],
            "avals": [[[1, 4], "float64"]], "donation": False, **own}})
    primed = []
    fresh = AotStore(d, donation=False, device=CPU)
    assert fresh.restore_all(primers={
        "gls": lambda avals: primed.append(avals) or torch.add,
        "phase": lambda avals: primed.append(avals) or torch.mul}) == 1
    assert primed == [[((1, 4), "float64")]]
    assert fresh.get("gls", (64, 8, 0, 1)) is None
    assert fresh.get("gls", (64, 8, 0, 2)) is None
    assert fresh.get("phase", (64, 4, 1)) is torch.mul
    assert (fresh.hits, fresh.misses) == (1, 2)


def _ns(which):
    if which == "ref":
        from pint_tpu.serve.journal import RequestJournal as J
    else:
        J = RequestJournal
    return types.SimpleNamespace(name=which, Journal=J)


def s_replay_set_and_torn_tail(ns, tmp):
    jpath = str(tmp / f"{ns.name}.jsonl")
    j = ns.Journal(jpath)
    j.admit("r1", {"kind": "x"})
    j.admit("r2", {"kind": "y"})
    j.ack("r1", "served")
    j.admit("r3", {"kind": "z"})
    j.ack("r3", "replayed")
    j.close()
    with open(jpath, "a") as fh:
        fh.write('{"op": "admit", "rid": "torn')
    j2 = ns.Journal(jpath)
    out = [[r["rid"] for r in j2.unacknowledged()]]
    counts = j2.counts()
    out.append({k: counts[k] for k in ("admitted", "acked",
                                       "unacknowledged", "compactions")})
    out.append(counts["bytes"] > 0)
    j2.ack("r2", "shed:shutdown")
    j2.ack("r3", "served")
    out.append(j2.unacknowledged())
    j2.close()
    return out


def s_auto_compaction(ns, tmp):
    out = []
    j = ns.Journal(str(tmp / f"{ns.name}1.jsonl"), compact_bytes=512)
    for i in range(64):
        j.admit(f"r{i}", {"kind": "x", "pad": "y" * 32})
        j.ack(f"r{i}", "served")
    j.admit("tail", {"kind": "x"})
    out += [j.compactions, [r["rid"] for r in j.unacknowledged()]]
    j.close()
    out.append(os.path.getsize(str(tmp / f"{ns.name}1.jsonl")))
    j2 = ns.Journal(str(tmp / f"{ns.name}2.jsonl"), compact_bytes=0)
    for i in range(64):
        j2.admit(f"r{i}", {"kind": "x", "pad": "y" * 32})
        j2.ack(f"r{i}", "served")
    out.append(j2.compactions)
    j2.close()
    j3 = ns.Journal(str(tmp / f"{ns.name}3.jsonl"), compact_bytes=256)
    for i in range(64):
        j3.admit(f"r{i}", {"kind": "x", "pad": "y" * 32})
    out += [len(j3.unacknowledged()), j3.compactions]
    j3.close()
    return out


@pytest.mark.parametrize("case", ["replay_set_and_torn_tail",
                                  "auto_compaction"])
def test_journal_shared_semantics(case, tmp_path):
    """tests/test_serve_restart.py's journal cases
    (test_journal_replay_set_and_torn_tail,
    test_journal_auto_compaction_past_threshold) through both packages:
    identical replay sets, counts, compaction counts and file sizes."""
    fn = globals()[f"s_{case}"]
    out = {w: fn(_ns(w), tmp_path) for w in ("ref", "port")}
    assert out["port"] == out["ref"]
    if case == "auto_compaction":
        compactions, live, size, never, n3, c3 = out["port"]
        assert compactions >= 1 and live == ["tail"] and size < 4 * 512
        assert never == 0 and n3 == 64 and c3 <= 8


def test_journal_compaction_replay_bit_identical(tmp_path, stock):
    import shutil

    jpath = str(tmp_path / "j.jsonl")
    jcopy = str(tmp_path / "j_uncompacted.jsonl")
    eng_a = ServeEngine(journal=jpath, device=CPU)
    batch = _mk_batch(stock)
    f0 = eng_a.submit(batch[0])
    eng_a.flush()
    f0.result(timeout=0)
    eng_a.submit(batch[1])
    eng_a.submit(batch[2])
    eng_a.journal.progress(batch[1].rid, 1)
    del eng_a
    shutil.copy(jpath, jcopy)
    j = RequestJournal(jpath)
    before = j.unacknowledged()
    assert len(before) == 2
    j.compact()
    assert j.counts()["compactions"] == 1
    assert j.unacknowledged() == before
    j.close()
    recs = [json.loads(x) for x in open(jpath)]
    assert [r["op"] for r in recs] == ["admit", "admit"]
    assert recs == before
    assert not (tmp_path / "j.jsonl.tmp").exists()
    res = []
    for path in (jpath, jcopy):
        eng = ServeEngine(journal=path, device=CPU)
        futs = eng.replay(_factory(stock))
        eng.flush()
        res.append([f.result(timeout=0) for f in futs])
        eng.stop()
    assert len(res[0]) == len(res[1]) == 2
    for a, b in zip(*res):
        _assert_bitwise(a, b)


def test_replay_does_not_duplicate_admit_records(tmp_path, stock):
    jpath = str(tmp_path / "journal.jsonl")
    eng_a = ServeEngine(journal=jpath, device=CPU)
    for r in _mk_batch(stock):
        eng_a.submit(r)
    del eng_a
    eng_b = ServeEngine(journal=jpath, device=CPU)
    futs = eng_b.replay(_factory(stock))
    assert len(futs) == 3
    eng_b.flush()
    for f in futs:
        f.result(timeout=0)
    admits = [o for o in map(json.loads, open(jpath))
              if o["op"] == "admit"]
    assert len(admits) == 3
    counts = RequestJournal(jpath).counts()
    assert {k: counts[k] for k in ("admitted", "acked",
                                   "unacknowledged")} == \
        {"admitted": 3, "acked": 3, "unacknowledged": 0}
    eng_b.stop()


def test_fleet_rehome_replay_bit_identical_and_warm_aot(
        tmp_path, stock, ref_batch_results):
    from pint_tpu_torch.serve.fleet import FleetFront

    aot = str(tmp_path / "aot")

    def mk_front(tag):
        return FleetFront(_factory(stock), n=2,
                          journal=str(tmp_path / f"{tag}.jsonl"),
                          aot_dir=aot, heartbeat_s=3600.0,
                          lease_ttl_s=7200.0, start=False,
                          engine_kwargs={"device": CPU})

    front_a = mk_front("ja")
    warm = _mk_batch(stock) + [
        FitStepRequest(problem=stock["problems"][0],
                       payload={"kind": "fit", "k": 0})]
    futs = [front_a.submit(r) for r in warm]
    for w in front_a.workers.values():
        w.engine.flush()
    for f in futs:
        f.result(timeout=30)
    assert sum(w.engine.cache.aot.exported
               for w in front_a.workers.values()) >= 3
    front_a.stop()

    eng_r = ServeEngine(device=CPU)
    rfuts = [eng_r.submit(r) for r in _mk_batch(stock)]
    eng_r.flush()
    ref = [f.result(timeout=0) for f in rfuts]
    eng_r.stop()

    front_b = mk_front("jb")
    for w in front_b.workers.values():
        assert w.engine.cache.aot.restored == 3
        assert w.engine.metrics.restart_info["warm"] is True
    surv = front_b.workers["w1"].engine
    futs = [front_b.submit(r) for r in _mk_batch(stock)]
    front_b.kill_worker("w0")
    assert front_b.sweep() == 2
    surv.flush()
    res = [f.result(timeout=30) for f in futs]
    assert surv.metrics.compile_count == 0
    assert surv.cache.aot.misses == 0
    for a, b, c in zip(res, ref, ref_batch_results):
        _assert_bitwise(a, b)
        _assert_matches_reference(a, c)
    assert front_b.journal.counts()["unacknowledged"] == 0
    assert front_b.snapshot()["counters"]["rehomed"] == 2
    front_b.stop()


def test_daemon_replays_unacked_journal(tmp_path):
    from pint_tpu_torch.scripts.pint_serve import main

    datadir = os.path.join(os.path.dirname(__file__), "datafile")
    rec = {"kind": "fit_step", "id": "r1",
           "par": os.path.join(datadir, "NGC6440E.par"),
           "tim": os.path.join(datadir, "NGC6440E.tim")}
    jpath = str(tmp_path / "j.jsonl")
    with open(jpath, "w") as fh:
        fh.write(json.dumps({"op": "admit", "rid": "r1",
                             "payload": rec}) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--device", CPU, "--window-ms", "2", "--journal",
                     jpath], stdin=iter(())) == 0
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    snap = lines[-1]
    assert snap["metric"] == "serve_session"
    res = [x for x in lines if x.get("id") == "r1"]
    assert len(res) == 1 and res[0]["ok"] and "chi2" in res[0]
    assert snap["restart"]["replayed"] == 1
    j = RequestJournal(jpath)
    assert j.unacknowledged() == []
    j.close()


def test_primed_zero_batch_is_masking_safe(tmp_path, stock):
    """The warm-restart priming runs each class program on a batch of
    padded slots (valid = pvalid = 0, unit nvec and phi): finite zeros
    out, exactly the identity system's answer."""
    from pint_tpu_torch.serve.bucket import _zero_batch
    from pint_tpu_torch.parallel.pta import _solve_one

    avals = [((2, 64, 8), "float64"), ((2, 64, 0), "float64"),
             ((2, 0), "float64"), ((2, 64), "float64"),
             ((2, 64), "float64"), ((2, 64), "float64"),
             ((2, 8), "float64")]
    dparams, cov, chi2, chi2r = _solve_one(*_zero_batch("gls", avals,
                                                        CPU))
    assert float(dparams.abs().max()) == 0.0
    assert float(chi2.abs().max()) == 0.0 == float(chi2r.abs().max())
    assert bool(cov.isfinite().all())
