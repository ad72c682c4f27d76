"""The performance-attribution plane of the port (pint_tpu_torch.obs.perf,
the supervisor's wall decomposition and the profiling scoreboard) held to
the reference's pint_tpu.obs.perf on the CPU.

``test_shared_semantics`` runs each case of tests/test_perf.py that does
not need the serve layer or XLA through both packages (the ledger's
registry parity and JSONL prior, the supervisor's first call, the
decomposition against the wall, the window bounds, rate limit and
auto-windows, the scoreboard's reset) and holds the outcomes equal. The
port's own cases: ``cost_probe`` (torch's FLOP counter) against a hand
count, the ``PEAKS`` table, K1's analytic cost and the roofline share
chip_smoke.py's bound gives, the device trace a window and ``trace``
write.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

ENV = ("PINT_TPU_PERF", "PINT_TPU_PROFILE_DIR", "PINT_TPU_PROFILE_MAX_S",
       "PINT_TPU_COMPILE_LEDGER", "PINT_TPU_FLIGHT_DIR", "PINT_TPU_TRACE",
       "PINT_TPU_DISPATCH_DEADLINE_MS", "PINT_TPU_BREAKER_THRESHOLD",
       "PINT_TPU_DISPATCH_RTT_MS", "PINT_TPU_SLO")


def _ns(which):
    if which == "ref":
        import pint_tpu.config as cfg
        import pint_tpu.profiling as prof
        import pint_tpu.runtime as rt
        from pint_tpu import obs
        from pint_tpu.obs import metrics as om
        from pint_tpu.obs import perf
        from pint_tpu.obs import slo
    else:
        import pint_tpu_torch.config as cfg
        import pint_tpu_torch.profiling as prof
        import pint_tpu_torch.runtime as rt
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import metrics as om
        from pint_tpu_torch.obs import perf
        from pint_tpu_torch.obs import slo
    return types.SimpleNamespace(name=which, config=cfg, rt=rt, obs=obs,
                                 om=om, perf=perf, slo=slo, prof=prof)


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


def _wait_closed(perf, timeout=20.0):
    t0 = time.time()
    while perf.get_profiler().status()["open"] is not None and \
            time.time() - t0 < timeout:
        time.sleep(0.05)
    return perf.get_profiler().status()["open"] is None


def _windows(d):
    return sorted(x for x in os.listdir(d) if x.startswith("window-")) \
        if os.path.isdir(d) else []


# ------------------------------------------------------------ scenarios


def s_ledger_parity(ns, mp, tmp):
    led = ns.perf.get_ledger()
    led.record("k1", backend="cpu", compile_wall_s=0.5, flops=1e9,
               bytes_accessed=2e8)
    led.record("k1", compile_wall_s=0.6)
    led.record("k2", backend="cpu", aot_restored=True)
    snap = led.snapshot()
    reg = ns.om.get_registry()
    return [snap["compiles"], int(reg.total("pint_tpu_perf_compiles_total")),
            int(reg.total("pint_tpu_perf_aot_restored_total")),
            snap["aot_restored"], snap["entries"]["k2"]["aot_restored"],
            snap["entries"]["k1"]["compile_wall_s"],
            reg.value("pint_tpu_perf_compile_wall_seconds", key="k1"),
            reg.value("pint_tpu_perf_cost_flops", key="k1"),
            sorted(snap["entries"]["k1"]), snap["total_compile_wall_s"]]


def s_ledger_prior(ns, mp, tmp):
    p = str(tmp / f"{ns.name}.jsonl")
    ns.perf.configure(ledger_path=p)
    ns.perf.get_ledger().record("a", backend="cpu", compile_wall_s=0.1,
                                flops=5.0)
    ns.perf.get_ledger().record("b", backend="cpu", compile_wall_s=0.2)
    keys = sorted(json.loads(x)["key"] for x in
                  open(p, encoding="utf-8").read().splitlines())
    ns.obs.reset()
    ns.perf.configure(ledger_path=p)
    led = ns.perf.get_ledger()
    snap = led.snapshot()
    return [keys, snap["compiles"], snap["prior"], led.get("a")["flops"]]


def s_first_call(ns, mp, tmp):
    sup = ns.rt.DispatchSupervisor()
    sup.dispatch(lambda: 1.0, key="unit.first")
    sup.dispatch(lambda: 2.0, key="unit.first")
    entry = ns.perf.get_ledger().get("unit.first")
    return [entry is not None, entry["compile_wall_s"] >= 0.0,
            entry["backend"], ns.perf.get_ledger().snapshot()["compiles"]]


def s_decomposition(ns, mp, tmp):
    ns.perf.configure(enabled=True)
    sup = ns.rt.DispatchSupervisor()

    def payload():
        time.sleep(0.01)
        return np.zeros(8)

    t0 = time.perf_counter()
    sup.dispatch(payload, key="unit.decomp", guard=True)
    wall = time.perf_counter() - t0
    row = sup.metrics.perf.snapshot()["cpu/unit.decomp"]
    phases = ("queue_wait", "host_assembly", "device_wall", "collect")
    total_s = sum(row[p]["mean_ms"] for p in phases) / 1e3
    return [sorted(row), all(row[p]["count"] == 1 for p in phases),
            total_s <= wall + 1e-3, row["host_assembly"]["mean_ms"] >= 9.0,
            "perf" in sup.metrics.snapshot()]


def s_decomposition_off(ns, mp, tmp):
    sup = ns.rt.DispatchSupervisor()
    sup.dispatch(lambda: np.zeros(4), key="unit.off", guard=True)
    return [len(sup.metrics.perf), "perf" in sup.metrics.snapshot()]


def s_window_disarmed(ns, mp, tmp):
    res = ns.perf.request_window(1, reason="t")
    reg = ns.om.get_registry()
    return [res["ok"], "armed" in res["error"],
            reg.total("pint_tpu_perf_profile_windows_total"),
            reg.total("pint_tpu_perf_profile_suppressed_total"),
            ns.perf.auto_window("breaker_open")]


def s_window_bounded(ns, mp, tmp):
    d = str(tmp / ns.name)
    ns.perf.configure(profile_dir=d, max_s=0.2)
    res = ns.perf.request_window(99, reason="t")
    res2 = ns.perf.request_window(1, reason="t")
    out = [res["ok"], res["seconds"] <= 0.2, res2["ok"],
           ns.om.get_registry().total(
               "pint_tpu_perf_profile_suppressed_total")]
    out.append(_wait_closed(ns.perf))
    meta = json.load(open(os.path.join(res["dir"], "window.json"),
                          encoding="utf-8"))
    res3 = ns.perf.request_window(0.05, reason="t")
    st = ns.perf.get_profiler().status()
    return out + [meta["status"] in ("closed", "aborted", "abandoned"),
                  meta["reason"], res3["ok"],
                  "rate-limited" in res3["error"], st["windows"],
                  st["last"]["reason"]]


def s_slo_window(ns, mp, tmp):
    fdir = str(tmp / ns.name / "flight")
    pdir = str(tmp / ns.name / "prof")
    ns.obs.configure(enabled=True, flight_dir=fdir)
    ns.perf.configure(profile_dir=pdir, max_s=0.2)
    spec = ns.slo.SLOSpec(name="unit_ratio", type="ratio",
                          bad=["unit_bad_total"], total=["unit_all_total"],
                          budget=0.01, fast_s=10.0, slow_s=30.0,
                          min_events=1, min_samples=1)
    bad = ns.om.counter("unit_bad_total")
    allc = ns.om.counter("unit_all_total")
    wd = ns.slo.SLOWatchdog(specs=[spec], interval_s=1.0)
    allc.inc(10)
    out = [wd.tick(now=0.0)]
    bad.inc(10)
    allc.inc(10)
    out.append(wd.tick(now=40.0))
    out.append(len(_windows(pdir)))
    bad.inc(10)
    allc.inc(10)
    out += [wd.tick(now=80.0), len(_windows(pdir)), _wait_closed(ns.perf)]
    wdir = os.path.join(pdir, _windows(pdir)[0])
    meta = json.load(open(os.path.join(wdir, "window.json"),
                          encoding="utf-8"))
    flight = (meta.get("extra") or {}).get("flight")
    fdoc = json.load(open(flight, encoding="utf-8"))
    sdoc = json.load(open(os.path.join(wdir, "spans.json"),
                          encoding="utf-8"))
    return out + [meta["reason"],
                  meta["status"] in ("closed", "aborted", "abandoned"),
                  os.path.exists(flight), fdoc["reason"],
                  isinstance(sdoc["traceEvents"], list),
                  all(e["ph"] in ("X", "i") and "ts" in e
                      for e in sdoc["traceEvents"])]


def s_window_backend_death(ns, mp, tmp):
    d = str(tmp / ns.name)
    ns.perf.configure(profile_dir=d, max_s=0.3)
    res = ns.perf.request_window(0.3, reason="chaos")
    sup = ns.rt.DispatchSupervisor()
    mp.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "200")
    with ns.rt.FaultPlan([ns.rt.Fault(match="unit.dead", kind="hang",
                                      seconds=2.0)]).active():
        out = sup.dispatch(lambda: np.ones(3), key="unit.dead",
                           fallback=lambda: np.zeros(3))
    closed = _wait_closed(ns.perf)
    meta = json.load(open(os.path.join(res["dir"], "window.json"),
                          encoding="utf-8"))
    return [res["ok"], out.tolist(), sup.metrics.failovers, closed,
            meta["status"] in ("closed", "aborted", "abandoned")]


def s_breaker_window(ns, mp, tmp):
    pdir = str(tmp / ns.name)
    ns.perf.configure(profile_dir=pdir, max_s=0.2)
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    sup = ns.rt.DispatchSupervisor()
    with ns.rt.FaultPlan([ns.rt.Fault(match="unit.trip", kind="error",
                                      count=8)]).active():
        out = sup.dispatch(lambda: 1.0, key="unit.trip",
                           fallback=lambda: -1.0)
        # the episode is one window: a second failure while open adds none
        out2 = sup.dispatch(lambda: 1.0, key="unit.trip",
                            fallback=lambda: -1.0)
    windows = _windows(pdir)
    _wait_closed(ns.perf)
    return [out, out2, len(windows), "breaker_open" in windows[0]]


def s_scoreboard(ns, mp, tmp):
    sb = ns.prof.scoreboard
    sb.reset()
    with sb.phase("unit-phase"):
        pass
    hist = ns.om.get_registry().get("pint_tpu_scoreboard_seconds")
    rows = [h for key, h in hist.rows() if ("phase", "unit-phase") in key]
    out = [sb.counts["unit-phase"], len(rows),
           rows[0] is sb._rows["unit-phase"], rows[0].count]
    ns.obs.reset()
    out.append(sb.totals)
    with sb.phase("unit-phase"):
        pass
    hist2 = ns.om.get_registry().get("pint_tpu_scoreboard_seconds")
    return out + [sb.counts["unit-phase"], hist2 is not None
                  and hist2 is not hist, sorted(sb.snapshot())]


def s_obs_status(ns, mp, tmp):
    ns.perf.get_ledger().record("k", backend="cpu", compile_wall_s=0.1)
    st = ns.obs.status()
    return [st["perf"]["compiles"], st["perf"]["decomposition_armed"],
            st["perf"]["ledger_path"]]


def s_env_parser(ns, mp, tmp):
    cfg, out = ns.config, []
    for v in ("on", "definitely"):
        mp.setenv("PINT_TPU_PERF", v)
        out.append(cfg.perf_enabled())
    out.append(cfg.perf_enabled(True))
    for v in ("-3", "7.5"):
        mp.setenv("PINT_TPU_PROFILE_MAX_S", v)
        out.append(cfg.profile_max_s())
    mp.setenv("PINT_TPU_PROFILE_DIR", "")
    out.append(cfg.profile_dir())
    mp.setenv("PINT_TPU_COMPILE_LEDGER", "")
    out.append(cfg.compile_ledger_path())
    mp.setenv("PINT_TPU_PROFILE_DIR", "/x")
    mp.setenv("PINT_TPU_COMPILE_LEDGER", "/y.jsonl")
    return out + [cfg.profile_dir(), cfg.compile_ledger_path()]


def s_roofline(ns, mp, tmp):
    entry = {"flops": 2e9, "bytes_accessed": 5e8, "backend": "cpu"}
    blk = ns.perf.roofline(entry, 1e-3)
    led = ns.perf.get_ledger()
    led.record("k", backend="cpu", flops=2e9, bytes_accessed=5e8)
    return [blk, ns.perf.roofline({}, 1e-3), ns.perf.roofline(entry, 0.0),
            ns.perf.roofline_block("k", 1e-3)]


def s_ledger_summary(ns, mp, tmp):
    """One CompileLedger snapshot through ``ledger_summary``: counts,
    the bounded key list and each key's recorded fields only."""
    led = ns.perf.get_ledger()
    led.record("fit.step", backend="cpu", compile_wall_s=0.25, flops=4e9,
               bytes_accessed=3e8, peak_bytes=1e7)
    led.record("gls.solve", backend="cpu", compile_wall_s=0.125)
    led.record("serve.unit", backend="cpu", aot_restored=True)
    return [ns.perf.ledger_summary(), ns.perf.ledger_summary(max_keys=2)]


SHARED = {
    "test_ledger_registry_vs_snapshot_parity": s_ledger_parity,
    "ledger_summary": s_ledger_summary,
    "test_ledger_jsonl_persists_and_restores_as_prior": s_ledger_prior,
    "test_supervisor_first_call_feeds_the_ledger": s_first_call,
    "test_decomposition_phases_sum_to_at_most_the_wall": s_decomposition,
    "test_decomposition_disarmed_records_nothing": s_decomposition_off,
    "test_window_disarmed_is_a_labeled_refusal_with_zero_records":
        s_window_disarmed,
    "test_window_bounded_and_rate_limited": s_window_bounded,
    "test_slo_burn_opens_exactly_one_crosslinked_window": s_slo_window,
    "test_window_survives_injected_backend_death": s_window_backend_death,
    "test_breaker_open_fires_an_auto_window": s_breaker_window,
    "test_scoreboard_rows_are_registry_shared_and_reset_clears":
        s_scoreboard,
    "test_obs_status_carries_the_perf_block": s_obs_status,
    "test_perf_enabled_env_parser": s_env_parser,
    "roofline_blocks": s_roofline,
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


# --------------------------------------------------------- the port's own


def test_peaks_hold_the_h100_data_sheet_only():
    from pint_tpu_torch.obs import perf

    assert perf.PEAKS == {"cuda": {"flops": 67e12, "bytes_per_s": 3.35e12}}
    blk = perf.roofline({"flops": 67e9, "bytes_accessed": 3.35e9}, 2e-3,
                        "cuda:0")
    assert blk["achieved_frac_flops"] == 0.5
    assert blk["achieved_frac_hbm"] == 0.5
    assert "achieved_frac_flops" not in perf.roofline(
        {"flops": 67e9}, 2e-3, "cpu")


def test_cost_probe_counts_matmuls_by_hand():
    """FlopCounterMode over one call: 2 n^3 for an (n, n) matmul, 2 m n k
    for an addmm, zero for elementwise work and a Cholesky; the ledger
    takes the count once per key."""
    from pint_tpu_torch.obs import perf

    x = torch.randn(64, 64, dtype=torch.float64)
    y = torch.randn(64, 32, dtype=torch.float64)
    spd = x @ x.T + 64 * torch.eye(64, dtype=torch.float64)

    def f(a, b):
        c = a @ a                                   # 2 * 64^3
        d = torch.addmm(b, a, b)                    # 2 * 64 * 64 * 32
        torch.linalg.cholesky(spd)                  # not counted
        return torch.sin(c).sum() + d.sum()         # not counted

    assert perf.cost_probe(f, (x, y)) == {
        "flops": float(2 * 64 ** 3 + 2 * 64 * 64 * 32)}
    assert perf.cost_probe(lambda a: torch.sin(a), (x,)) == {}
    assert perf.cost_probe(lambda: 1 / 0, ()) == {}
    calls = []

    def g(a):
        calls.append(1)
        return a @ a

    perf.note_compile("unit.mm", backend="cuda:0", fn=g, args=(x,))
    perf.note_compile("unit.mm", compile_wall_s=0.5, fn=g, args=(x,))
    entry = perf.get_ledger().get("unit.mm")
    assert entry["flops"] == 2 * 64 ** 3 and len(calls) == 1
    assert entry["compile_wall_s"] == 0.5
    blk = perf.roofline_block("unit.mm", 1e-3)
    assert blk["gflops_achieved"] == pytest.approx(
        entry["flops"] / 1e-3 / 1e9, rel=0.01)
    # the block rounds fractions to 6 decimals
    assert blk["achieved_frac_flops"] == pytest.approx(
        entry["flops"] / 1e-3 / 67e12, abs=1e-6)


def test_k1_cost_and_the_share_of_bound():
    """K1's analytic cost at the smoke's shape (PERF.md's counts), and the
    roofline share of it against the bound chip_smoke.py states; the
    plain path (a CPU tensor) registers nothing."""
    import chip_smoke
    from pint_tpu_torch.obs import perf
    from pint_tpu_torch.ops import z2_harmonics as zmod

    c = zmod.cost(4_194_304, 20, 16)
    assert c == {"flops": 754_974_720.0, "bytes_accessed": 67_109_184.0}
    bound_ms, by, nbytes, ops = chip_smoke.bound(4_194_304, 20, 16)
    assert (nbytes, ops, by) == (67_109_184, 754_974_720, "bytes")
    wall_ms = 0.0375
    blk = perf.roofline(c, wall_ms / 1e3, "cuda:0")
    share = max(blk["achieved_frac_flops"], blk["achieved_frac_hbm"])
    assert share == pytest.approx(bound_ms / wall_ms, rel=1e-3)
    zmod.z2_harmonics(torch.zeros(8, dtype=torch.float64),
                      torch.ones(8, dtype=torch.float64), 2)
    assert perf.get_ledger().get("z2_harmonics") is None


def test_window_writes_the_device_trace(tmp_path):
    """A window's own thread starts and stops torch.profiler: the trace
    of the ops run meanwhile (on other threads too) lands beside
    window.json."""
    from pint_tpu_torch.obs import perf

    perf.configure(profile_dir=str(tmp_path), max_s=0.5)
    res = perf.request_window(0.5, reason="unit")
    assert res["ok"]
    x = torch.randn(128, 128)
    for _ in range(4):
        x = torch.tanh(x @ x)
    perf.get_profiler().stop_open()
    meta = json.load(open(os.path.join(res["dir"], "window.json"),
                          encoding="utf-8"))
    assert meta["status"] == "closed", meta
    trace = json.load(open(meta["device_trace"], encoding="utf-8"))
    assert isinstance(trace["traceEvents"], list)


def test_trace_and_annotate(tmp_path):
    """``trace`` writes a Chrome trace of the block; ``annotate`` names a
    region in it, in the scoreboard and as a span."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.profiling import annotate, scoreboard, trace

    tracer = obs.configure(enabled=True)
    with trace(str(tmp_path)):
        with annotate("unit.region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    doc = json.load(open(tmp_path / "trace.json", encoding="utf-8"))
    assert any(e.get("name") == "unit.region" for e in doc["traceEvents"])
    assert scoreboard.counts["unit.region"] == 1
    assert "unit.region" in scoreboard.report()
    assert any(r["name"] == "unit.region" for r in tracer.records())
    with trace(None):
        pass


def test_fit_stats_moved_to_profiling():
    """FitStats lives in profiling (fitter re-exports it), with the
    reference's fields."""
    import dataclasses

    from pint_tpu.profiling import FitStats as RFitStats
    from pint_tpu_torch import fitter, profiling

    assert fitter.FitStats is profiling.FitStats
    assert [f.name for f in dataclasses.fields(profiling.FitStats)] == \
        [f.name for f in dataclasses.fields(RFitStats)]
    s = profiling.FitStats(fitter="X", chi2=1.0, phases={"a": 0.5})
    assert json.loads(s.to_json())["phases"] == {"a": 0.5}
    assert str(s).startswith("X: chi2=1.000")
