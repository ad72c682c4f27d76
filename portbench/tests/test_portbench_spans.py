"""The readers of the program's span ring (``portbench/spans.py`` and the
per-layer metrics that use it) on a synthetic traced window and ring:
each gives its hand-computed value, and None without its spans."""

import pytest

from portbench import registry, spans
from portbench.trace import TraceWindow

OFFSET_S = 1000.0  # the ring's axis less the trace's
JITTER_US = (12.0, -8.0, 5.0, 0.0, -15.0, 9.0)


def _rec(name, t0, t1, sid, parent=None, k=0, **args):
    """A completed ring record at trace seconds [t0, t1]."""
    a = dict(args, trace="t1", span=sid)
    if parent is not None:
        a["parent"] = parent
    ts = (t0 + OFFSET_S) * 1e6 + JITTER_US[k % len(JITTER_US)]
    return {"name": name, "ph": "X", "ts": ts, "dur": (t1 - t0) * 1e6,
            "args": a}


def gwb_window():
    """Two sweep chunks of 8 points in a 0.1 s window (and a chunk of an
    earlier call, outside it): the trace's host ranges and device
    operations, and the ring."""
    host = [(0.0, 0.1, "portbench.call"),
            (0.009, 0.031, "pta.gwb_sweep"),
            (0.010, 0.030, "dispatch/pta.gwb/chunk0"),
            (0.039, 0.061, "pta.gwb_sweep"),
            (0.040, 0.060, "dispatch/pta.gwb/chunk1")]
    ops = [(0.015, 0.025, "potrf"), (0.046, 0.055, "potrf"),
           (0.070, 0.075, "copy")]
    ring = [
        # an earlier call, five seconds before the window
        _rec("dispatch/pta.gwb/chunk0", -4.990, -4.970, 90, k=3),
        _rec("dispatch.run", -4.988, -4.984, 91, 90),
        _rec("pta.gwb_sweep", 0.009, 0.031, 9, k=1, chunk=0),
        _rec("dispatch/pta.gwb/chunk0", 0.010, 0.030, 1, 9, k=0),
        _rec("dispatch.run", 0.012, 0.016, 2, 1),
        _rec("pta.gwb.outer", 0.014, 0.016, 4, 2),
        _rec("dispatch.read", 0.016, 0.028, 3, 1),
        _rec("pta.gwb_sweep", 0.039, 0.061, 10, k=4, chunk=1),
        _rec("dispatch/pta.gwb/chunk1", 0.040, 0.060, 5, 10, k=2),
        _rec("dispatch.run", 0.041, 0.047, 6, 5),
        _rec("pta.gwb.outer", 0.045, 0.047, 8, 6),
        _rec("dispatch.read", 0.047, 0.058, 7, 5),
    ]
    return TraceWindow(ops, {}, host, 3, 0.1), ring


def grid_window():
    """One grid in the window, its rebuild 10 ms; an earlier grid's
    spans in the ring only."""
    host = [(0.0, 0.1, "portbench.call"),
            (0.001, 0.090, "grid.chisq"),
            (0.002, 0.012, "grid.build"),
            (0.012, 0.050, "grid.chunk"),
            (0.050, 0.085, "grid.chunk"),
            (0.085, 0.089, "grid.read")]
    ring = [_rec("grid.chisq", -7.0, -6.5, 50, k=0),
            _rec("grid.build", -6.99, -6.90, 51, 50, k=1),
            _rec("grid.chisq", 0.001, 0.090, 1, k=2),
            _rec("grid.build", 0.002, 0.012, 2, 1, k=3),
            _rec("grid.chunk", 0.012, 0.050, 3, 1, k=4),
            _rec("grid.chunk", 0.050, 0.085, 4, 1, k=5),
            _rec("grid.read", 0.085, 0.089, 5, 1, k=0)]
    return TraceWindow([(0.013, 0.05, "k")], {}, host, 1, 0.1), ring


def _read(metric, trace, ring, monkeypatch, points=16):
    monkeypatch.setattr(spans, "ring", lambda: ring)
    ctx = {"trace": trace, "points": points, "dims": {}, "counters": {},
           "calls": [], "elapsed_s": 1.0}
    return registry.module("layer_metrics", metric).read(ctx)


# (metric, window, hand-computed value)
CASES = [
    # chunk0: 20 - 4 - 12 = 4 ms; chunk1: 20 - 6 - 11 = 3 ms
    ("handoff_ms_per_chunk.gwb", gwb_window, 3.5),
    # dispatch.run: 4 and 6 ms
    ("issue_ms_per_chunk.gwb", gwb_window, 5.0),
    # busy and chunks cover [10, 30] + [40, 60] + [70, 75] ms of 100
    ("idle_outside_dispatch.gwb", gwb_window, 0.55),
    # [14, 28] holds 10 ms of busy, [45, 58] 9 ms: 19 ms over 16 points
    ("outer_device_ms_per_point.gwb", gwb_window, 19.0 / 16),
    ("build_ms_per_grid.grid", grid_window, 10.0),
]


@pytest.mark.parametrize("metric, make, want", CASES)
def test_reader_gives_its_hand_value(metric, make, want, monkeypatch):
    trace, ring = make()
    assert _read(metric, trace, ring, monkeypatch) == \
        pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("metric, make, want", CASES)
def test_reader_is_none_without_its_spans(metric, make, want, monkeypatch):
    """An empty ring (a program that records no span), and a ring whose
    spans the trace does not hold, read None."""
    trace, ring = make()
    assert _read(metric, trace, [], monkeypatch) is None
    stray = [dict(r, name="other." + r["name"]) for r in ring]
    assert _read(metric, trace, stray, monkeypatch) is None


@pytest.mark.parametrize("metric", ["handoff_ms_per_chunk.gwb",
                                    "issue_ms_per_chunk.gwb",
                                    "outer_device_ms_per_point.gwb"])
def test_chunk_readers_need_the_worker_spans(metric, monkeypatch):
    """Dispatch spans without their ``dispatch.run`` children (a program
    that does not carry spans into the worker) read None."""
    trace, ring = gwb_window()
    bare = [r for r in ring if not r["name"].startswith(("dispatch.",
                                                          "pta.gwb."))]
    assert _read(metric, trace, bare, monkeypatch) is None


def test_device_readers_need_a_device_trace(monkeypatch):
    """With no device operation in the window (the CPU) the device-trace
    readers read None."""
    trace, ring = gwb_window()
    host_only = TraceWindow([], {}, trace.host, 0, trace.window_s)
    for metric in ("idle_outside_dispatch.gwb",
                   "outer_device_ms_per_point.gwb"):
        assert _read(metric, host_only, ring, monkeypatch) is None


def test_alignment_finds_the_offset_and_its_spread(monkeypatch):
    """The matched offsets are the window's pairs alone (not the earlier
    call's), their median the offset and their spread the jitter's."""
    trace, ring = gwb_window()
    monkeypatch.setattr(spans, "ring", lambda: ring)
    w = spans.window({"trace": trace})
    assert len(w.offsets) == 4
    # jitters -8, 12, -15 and 5 us: median -1.5 us
    assert w.offset_s == pytest.approx(OFFSET_S - 1.5e-6, abs=1e-9)
    assert w.spread_s < 30e-6
    assert {s.id for s in w.spans} == set(range(1, 11))


def test_alignment_matches_the_call_root(monkeypatch):
    """A synchronous ``loglik_grid``'s root span is one more matched
    pair; the worker's spans stay unmatched."""
    trace, ring = gwb_window()
    trace.host.append((0.005, 0.065, "pta.gwb.loglik_grid"))
    ring = ring + [_rec("pta.gwb.loglik_grid", 0.005, 0.065, 11, k=5)]
    monkeypatch.setattr(spans, "ring", lambda: ring)
    w = spans.window({"trace": trace})
    assert len(w.offsets) == 5
    # jitters -8, 12, -15, 5 and 9 us: median 5 us
    assert w.offset_s == pytest.approx(OFFSET_S + 5e-6, abs=1e-9)
    assert not any(spans._matched(n) for n in
                   ("dispatch.run", "dispatch.read", "pta.gwb.outer",
                    "pta.gwb.upload"))


def test_idle_outside_is_at_most_the_idle_share(monkeypatch):
    trace, ring = gwb_window()
    got = _read("idle_outside_dispatch.gwb", trace, ring, monkeypatch)
    idle = registry.module("layer_metrics", "idle_share.gwb").read(
        {"trace": trace})
    assert got <= idle
