"""The port's one instrumentation surface (``pint_tpu_torch.obs.span``) on
the profiler's trace, across the dispatch worker and in the grid and GWB
host phases, on the CPU.

A span records into the ring while the tracer is on or a
``torch.profiler`` session is open anywhere in the process; on a thread
the profiler records it is also a ``record_function`` range of the same
name. The ring stamps real-time microseconds, the axis the profiler's
host events are on.
"""

import gc
import json
import os
import time
import tracemalloc

import numpy as np
import pytest
import torch

from pint_tpu_torch import obs
from pint_tpu_torch.obs import tracer as otracer
from pint_tpu_torch.runtime import DispatchSupervisor, reset_runtime

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
DATA = os.path.join(os.path.dirname(__file__), "datafile")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("PINT_TPU_TRACE", "PINT_TPU_TRACE_STREAM",
                 "PINT_TPU_FLIGHT_DIR", "PINT_TPU_PROFILE_DIR"):
        monkeypatch.delenv(name, raising=False)
    reset_runtime()
    obs.reset()
    yield
    reset_runtime()
    obs.reset()


def _by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def _one(recs, name):
    got = _by_name(recs, name)
    assert len(got) == 1, (name, [r["name"] for r in recs])
    return got[0]


def _abs_starts_us(prof, name):
    """Starts [us on the real-time axis] of the profiler's host events
    called ``name``."""
    base = prof.profiler.kineto_results.trace_start_ns() / 1e3
    return [base + e.time_range.start for e in prof.events()
            if e.name == name and e.device_type ==
            torch.autograd.DeviceType.CPU]


# ------------------------------------------------------------ the surface


def test_off_span_is_the_shared_noop_and_allocates_nothing(monkeypatch):
    """Tracer off and no profiler: every entry point returns the shared
    no-op, builds no handle and no record, and 10,000 calls after a
    warm-up leave no memory behind."""
    assert not obs.recording()

    def refuse(*a, **k):
        raise AssertionError("allocated on the off path")

    monkeypatch.setattr(otracer.SpanHandle, "__init__", refuse)
    monkeypatch.setattr(otracer.Tracer, "_record", refuse)
    assert obs.span("x", key=1) is obs.NOOP_SPAN
    assert obs.open_span("x") is obs.NOOP_SPAN
    assert obs.open_root("x") is obs.NOOP_SPAN

    def calls(n):
        for _ in range(n):
            with obs.span("x", key=1) as sp:
                sp.set(a=1)
            obs.open_span("y").end()
            obs.event("z")
            obs.record_span("w", 0.0, 1.0)

    gc.collect()
    tracemalloc.start()
    try:
        calls(100)  # the interpreter's one-off caches
        before = tracemalloc.take_snapshot()
        calls(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = os.path.dirname(otracer.__file__)
    grown = [s for s in after.compare_to(before, "filename")
             if s.traceback[0].filename.startswith(here) and s.size_diff]
    assert grown == []
    assert len(obs.get_tracer()) == 0


def test_profiler_session_records_the_span_on_its_axis():
    """A span opened inside a profiler window is among the profiler's
    events under its name and in the ring; their starts agree on the
    real-time axis within 1 ms (this host; the card's spread is in
    PERF.md)."""
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        # the session alone turns recording on
        assert obs.recording() and not obs.get_tracer().recording
        with obs.span("unit.warm"):
            pass
        with obs.span("unit.profiled", k=3) as sp:
            torch.ones(4).add_(1)
            assert sp is not obs.NOOP_SPAN
    assert not obs.recording()
    rec = _one(obs.get_tracer().records(), "unit.profiled")
    assert rec["args"]["k"] == 3 and rec["dur"] > 0
    starts = _abs_starts_us(prof, "unit.profiled")
    assert len(starts) == 1
    assert abs(rec["ts"] - starts[0]) < 1e3
    # the window closed: off again
    assert obs.span("after") is obs.NOOP_SPAN


def test_unprofiled_thread_records_the_ring_only(monkeypatch):
    """A thread the session does not profile records its spans in the
    ring and enters no profiler range."""
    import threading

    entered = []
    real = otracer._thread_profiled
    monkeypatch.setattr(otracer, "_thread_profiled",
                        lambda: entered.append(real()) or entered[-1])
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        th = threading.Thread(
            target=lambda: obs.span("unit.thread").__enter__().__exit__(
                None, None, None))
        th.start()
        th.join()
    assert entered == [False]
    assert _by_name(obs.get_tracer().records(), "unit.thread")
    assert _abs_starts_us(prof, "unit.thread") == []


def test_ring_axis_is_the_real_time_clock():
    """``ts`` is real-time microseconds; perf-counter and monotonic
    stamps map onto it."""
    tr = obs.configure(enabled=True)
    wall = time.time_ns() / 1e3
    assert abs(tr.perf_us(time.perf_counter()) - wall) < 5e3
    assert abs(tr.monotonic_us(time.monotonic()) - wall) < 5e3
    with obs.span("unit.clock"):
        pass
    rec = _one(tr.records(), "unit.clock")
    assert abs(rec["ts"] - wall) < 5e3


def test_export_states_its_clock(tmp_path):
    """The Chrome export names its axis, and a base moves every ``ts``
    by it."""
    tr = obs.configure(enabled=True)
    with obs.span("unit.export"):
        pass
    ts = _one(tr.records(), "unit.export")["ts"]
    path = str(tmp_path / "spans.json")
    assert obs.export(path, base_us=1e6) == 1
    doc = json.load(open(path, encoding="utf-8"))
    assert doc["otherData"]["clock"] == "realtime_us"
    assert doc["otherData"]["ts_base_us"] == 1e6
    assert doc["traceEvents"][0]["ts"] == pytest.approx(ts - 1e6, abs=1e-3)


def test_profiler_window_spans_line_up_with_its_trace(tmp_path):
    """A profiler window's ``spans.json`` lies on its ``trace.json``'s
    axis: its ``ts_base_us`` is the trace's ``baseTimeNanoseconds``, and
    a span of the window lies between the trace's first and last
    events."""
    from pint_tpu_torch.obs import perf

    perf.configure(profile_dir=str(tmp_path), max_s=5.0)
    res = perf.request_window(5.0, reason="unit")
    assert res["ok"]
    with obs.span("unit.window"):
        torch.ones(8).mul_(2)
    perf.get_profiler().stop_open()
    doc = json.load(open(os.path.join(res["dir"], "spans.json"),
                         encoding="utf-8"))
    trace = json.load(open(os.path.join(res["dir"], "trace.json"),
                           encoding="utf-8"))
    assert doc["otherData"]["ts_base_us"] == \
        trace["baseTimeNanoseconds"] / 1e3
    mine = _one(doc["traceEvents"], "unit.window")
    stamps = [e["ts"] for e in trace["traceEvents"]
              if isinstance(e.get("ts"), (int, float))]
    assert min(stamps) <= mine["ts"] <= mine["ts"] + mine["dur"] \
        <= max(stamps)


# -------------------------------------------------------- dispatch worker


@pytest.mark.parametrize("guard", [True, False])
def test_worker_span_lands_under_the_dispatch(guard):
    """A span opened in the dispatch payload parents under
    ``dispatch.run``, a child of ``dispatch/<key>``, in that span's
    trace; a guarded dispatch adds ``dispatch.read``, and the run and
    read lie inside the dispatch."""
    tr = obs.configure(enabled=True)
    sup = DispatchSupervisor()

    def payload():
        with obs.span("unit.payload"):
            return torch.arange(3.0)

    with obs.span("unit.caller"):
        out = sup.dispatch(payload, key="unit.k", guard=guard)
    assert out.tolist() == [0.0, 1.0, 2.0]
    recs = tr.records()
    d = _one(recs, "dispatch/unit.k")
    run = _one(recs, "dispatch.run")
    inner = _one(recs, "unit.payload")
    assert d["args"]["parent"] == _one(recs, "unit.caller")["args"]["span"]
    assert run["args"]["parent"] == d["args"]["span"]
    assert inner["args"]["parent"] == run["args"]["span"]
    assert {r["args"]["trace"] for r in (d, run, inner)} == \
        {d["args"]["trace"]}
    reads = _by_name(recs, "dispatch.read")
    if guard:
        assert len(reads) == 1
        rd = reads[0]
        assert rd["args"]["parent"] == d["args"]["span"]
        assert run["tid"] == inner["tid"] == rd["tid"] != d["tid"]
        slack = 50.0  # us: the two stamps of one instant
        assert run["ts"] + run["dur"] <= rd["ts"] + slack
        for r in (run, rd):
            assert d["ts"] - slack <= r["ts"]
            assert r["ts"] + r["dur"] <= d["ts"] + d["dur"] + slack
    else:
        assert reads == []
        assert run["tid"] == d["tid"]


def test_worker_spans_share_the_decomposition_stamps(monkeypatch):
    """Armed, the wall decomposition and the spans read one set of
    stamps: host_assembly is dispatch.run, device_wall dispatch.read."""
    monkeypatch.setenv("PINT_TPU_PERF", "1")
    tr = obs.configure(enabled=True)
    sup = DispatchSupervisor()
    sup.dispatch(lambda: time.sleep(0.01) or torch.ones(2), key="unit.ph",
                 guard=True)
    recs = tr.records()
    ph = next(r for r in recs if r["name"] == "perf.phases")["args"]
    run = _one(recs, "dispatch.run")
    rd = _one(recs, "dispatch.read")
    assert run["dur"] / 1e3 == pytest.approx(ph["host_assembly_ms"],
                                             abs=2e-3)
    assert rd["dur"] / 1e3 == pytest.approx(ph["device_wall_ms"],
                                            abs=2e-3)


def test_failing_payload_ends_its_run_span_in_error():
    tr = obs.configure(enabled=True)
    sup = DispatchSupervisor()

    def boom():
        raise ValueError("caller bug")

    with pytest.raises(ValueError):
        sup.dispatch(boom, key="unit.bad", guard=True)
    run = _one(tr.records(), "dispatch.run")
    assert run["args"]["status"] == "error"
    assert _by_name(tr.records(), "dispatch.read") == []


# ------------------------------------------------------ fit step ranges


@pytest.fixture(scope="module")
def ngc():
    import warnings

    from pint_tpu_torch.models.model_builder import get_model_and_toas

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model_and_toas(os.path.join(DATA, "NGC6440E.par"),
                                  os.path.join(DATA, "NGC6440E.tim"),
                                  device="cpu")


@pytest.fixture(scope="module")
def ngc_step(ngc):
    from pint_tpu_torch.parallel.fit_step import build_fit_step

    model, toas = ngc
    return build_fit_step(model, toas)


def test_fit_step_ranges_reach_the_profiler(ngc_step):
    """The step's ``fit_step.*`` spans are ranges of a profiler window
    (and ring spans), as the benchmark's readers need."""
    step, args, _ = ngc_step
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        step(*args)
    names = {e.name for e in prof.events()}
    ring = {r["name"] for r in obs.get_tracer().records()}
    for want in ("fit_step.phase_jacobian", "fit_step.gram",
                 "fit_step.cholesky_solves"):
        assert want in names and want in ring


def test_fit_step_enters_no_range_when_nothing_profiles(ngc_step,
                                                        monkeypatch):
    """With the tracer off and no session, the step opens no profiler
    range and records nothing."""
    from torch.autograd import profiler as tap

    calls = []
    monkeypatch.setattr(tap, "record_function",
                        lambda *a, **k: calls.append(a))
    step, args, _ = ngc_step
    step(*args)
    assert calls == [] and len(obs.get_tracer()) == 0


# ------------------------------------------------------------ host phases


def test_grid_chisq_spans(ngc, monkeypatch):
    """``grid.chisq`` holds ``grid.build``, one ``grid.chunk`` a chunk
    and ``grid.read``, with its nodes and chunk size."""
    from pint_tpu_torch import config
    from pint_tpu_torch.gridutils import grid_chisq

    model, toas = ngc
    monkeypatch.setattr(config, "grid_chunk", lambda n, p: 2)
    tr = obs.configure(enabled=True)
    f0, f1 = model.get_param("F0").value, model.get_param("F1").value
    chi2 = grid_chisq(model, toas, ("F0", "F1"),
                      [f0 + np.array([-1e-10, 0.0, 1e-10]),
                       f1 + np.array([0.0])], maxiter=1)
    assert chi2.shape == (3, 1) and np.all(np.isfinite(chi2))
    recs = tr.records()
    root = _one(recs, "grid.chisq")
    assert root["args"]["nodes"] == 3 and root["args"]["chunk"] == 2
    rid = root["args"]["span"]
    build = _one(recs, "grid.build")
    read = _one(recs, "grid.read")
    chunks = _by_name(recs, "grid.chunk")
    assert [c["args"]["first"] for c in chunks] == [0, 2]
    for r in [build, read] + chunks:
        assert r["args"]["parent"] == rid
    assert build["ts"] + build["dur"] <= chunks[0]["ts"] + 1.0
    assert chunks[-1]["ts"] + chunks[-1]["dur"] <= read["ts"] + 1.0


def _tiny_array(npsr=3, ntoa=32, seed=7):
    from pint_tpu_torch.parallel.pta import PulsarProblem
    from pint_tpu_torch.pta import GWBLikelihood
    from pint_tpu_torch.toa import get_TOAs_array

    rng = np.random.default_rng(seed)
    problems = []
    for p in range(npsr):
        mjd = np.sort(53000.0 + 3000.0 * rng.random(ntoa))
        toas = get_TOAs_array(mjd, obs="barycenter", freqs=1400.0,
                              errors=1.0, device="cpu")
        t = (mjd - mjd.mean()) / 1500.0
        M = np.stack([np.ones(ntoa), t, t * t], axis=1) * 1e-6
        F = np.stack([np.sin(2 * np.pi * t), np.cos(2 * np.pi * t)], 1)
        problems.append(PulsarProblem(
            M, 1e-6 * rng.standard_normal(ntoa), np.full(ntoa, 1e-12), F,
            np.full(2, 1e-12), ["Offset", "c1", "c2"], toas=toas))
    pos = rng.standard_normal((npsr, 3))
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    return GWBLikelihood(problems=problems, positions=pos, nfreq=2,
                         device="cpu")


@pytest.fixture(scope="module")
def tiny_like():
    return _tiny_array()


@pytest.mark.parametrize("guard", [False, True])
def test_gwb_sweep_span_chain(tiny_like, guard, monkeypatch):
    """A sweep gives ``pta.gwb.loglik_grid`` > ``pta.gwb_sweep`` >
    ``dispatch/pta.gwb/chunk<c>`` > ``dispatch.run`` > ``pta.gwb.upload``
    and ``pta.gwb.outer``; the chunks' ``padded`` sum to the padding."""
    from pint_tpu_torch.runtime import supervisor as sv

    if guard:
        real = sv.DispatchSupervisor.dispatch

        def guarded(self, *a, **k):
            k["guard"] = True
            return real(self, *a, **k)

        monkeypatch.setattr(sv.DispatchSupervisor, "dispatch", guarded)
    tiny_like.build_blocks()
    tr = obs.configure(enabled=True)
    la = np.linspace(-15.0, -14.0, 10)
    ga = np.linspace(3.0, 5.0, 10)
    vals = tiny_like.loglik_grid(la, ga, chunk=4)
    assert vals.shape == (10,) and np.all(np.isfinite(vals))
    recs = tr.records()
    by_id = {r["args"]["span"]: r for r in recs}
    root = _one(recs, "pta.gwb.loglik_grid")
    assert root["args"]["points"] == 10 and root["args"]["chunk"] == 4
    sweeps = _by_name(recs, "pta.gwb_sweep")
    assert [s["args"]["padded"] for s in sweeps] == [0, 0, 2]
    assert sum(s["args"]["padded"] for s in sweeps) == 3 * 4 - 10
    for s in sweeps:
        assert s["args"]["parent"] == root["args"]["span"]
    outers = _by_name(recs, "pta.gwb.outer")
    assert len(outers) == 3 and len(_by_name(recs, "pta.gwb.upload")) == 3
    for o in outers:
        run = by_id[o["args"]["parent"]]
        d = by_id[run["args"]["parent"]]
        sweep = by_id[d["args"]["parent"]]
        assert run["name"] == "dispatch.run"
        assert d["name"] == f"dispatch/pta.gwb/chunk{o['args']['chunk']}"
        assert sweep["name"] == "pta.gwb_sweep"
        assert sweep["args"]["chunk"] == o["args"]["chunk"]
    assert len(_by_name(recs, "dispatch.read")) == (3 if guard else 0)


def test_gwb_async_collect_parents_chunks_under_the_caller(tiny_like):
    """``sync=False``: no root of its own (nothing reads one); the
    chunks the collect gathers parent under the caller's span."""
    tiny_like.build_blocks()
    tr = obs.configure(enabled=True)
    collect = tiny_like.loglik_grid([-14.5, -14.2], [4.0, 4.3], chunk=1,
                                    sync=False)
    with obs.span("unit.caller") as caller:
        vals = collect()
    assert np.all(np.isfinite(vals))
    assert _by_name(tr.records(), "pta.gwb.loglik_grid") == []
    sweeps = _by_name(tr.records(), "pta.gwb_sweep")
    assert len(sweeps) == 2
    assert {s["args"]["parent"] for s in sweeps} == {caller.span_id}


def test_annotate_is_one_span():
    """``profiling.annotate`` is a profiler range through its span only:
    one range of its name in the window."""
    from pint_tpu_torch.profiling import annotate

    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with annotate("unit.annotated"):
            torch.ones(2).add_(1)
    assert len(_abs_starts_us(prof, "unit.annotated")) == 1
    assert _by_name(obs.get_tracer().records(), "unit.annotated")


# ---------------------------------------------------------------- smoke


@pytest.mark.parametrize("work, want", [
    ([(0.0, 2.0, "a"), (1.0, 3.0, "b")], 3.0),
    ([(0.0, 1.0, "a"), (2.0, 3.0, "b")], 2.0),
    ([(0.0, 4.0, "a"), (1.0, 2.0, "b"), (3.0, 5.0, "c")], 5.0),
    ([], 0.0),
])
def test_chip_smoke_busy_is_the_union(work, want):
    """``chip_smoke.busy_us`` counts overlapping device intervals once."""
    import chip_smoke

    assert chip_smoke.busy_us(work) == want
