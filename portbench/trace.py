"""A ``torch.profiler`` window of a few calls, reduced to what the
per-layer readers and the result line need.

Device busy time is the union of the intervals in which an operation
(kernel, copy or set) ran on the device, not the sum of their durations,
so overlapping streams are counted once. Ranges opened with
``torch.profiler.record_function`` (the program's ``fit_step.*`` stages,
the harness's ``portbench.call``) come back as device-side ranges that a
reader can intersect with the busy intervals.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint union of (start, end) intervals, sorted."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class TraceWindow:
    """Device operations, user ranges, host operations and kernel
    launches of one profiled window; times in seconds."""

    def __init__(self, ops, ranges, host, launches: int, wall_s: float,
                 launched_at=None):
        self.ops = ops                # [(start, end, name)] on the device
        self.ranges = ranges          # {name: [(start, end)]} on the device
        self.host = host              # [(start, end, name)] on the host
        self.launches = launches
        self.window_s = wall_s
        # host time at which each device op was issued (None: unknown)
        self.launched_at = launched_at or [None] * len(ops)
        self.busy_intervals = union([(a, b) for a, b, _ in ops])
        self.busy_s = sum(b - a for a, b in self.busy_intervals)

    def range_busy_s(self, names) -> float:
        """Device-busy seconds under the ranges called ``names``: the
        device-side ranges intersected with the busy intervals where the
        trace has them, else the device time of the operations issued
        while one of the host-side ranges was open."""
        dev = union([iv for n in names for iv in self.ranges.get(n, [])])
        if dev:
            total, i = 0.0, 0
            busy = self.busy_intervals
            for a, b in dev:
                while i < len(busy) and busy[i][1] <= a:
                    i += 1
                j = i
                while j < len(busy) and busy[j][0] < b:
                    total += min(b, busy[j][1]) - max(a, busy[j][0])
                    j += 1
            return total
        host = union([(a, b) for a, b, n in self.host if n in names])
        if not host:
            return 0.0
        starts = [a for a, _ in host]
        total = 0.0
        for (a, b, _), t in zip(self.ops, self.launched_at):
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= host[k][1]:
                total += b - a
        return total

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the innermost host operation or range
        open across it and the host operation that ended last before."""
        by_name: Dict[str, float] = {}
        for a, b, n in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = [(self.busy_intervals[i][1], self.busy_intervals[i + 1][0])
                for i in range(len(self.busy_intervals) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            under = [h for h in self.host if h[0] <= mid <= h[1]]
            inner = min(under, key=lambda h: h[1] - h[0])[2] if under \
                else "host"
            done = [h for h in self.host if h[1] <= mid]
            last = max(done, key=lambda h: h[1])[2] if done else "start"
            named.append([f"{inner}, after {last}", b - a])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": named}


class DeviceBusy:
    """Device-busy seconds of the calls it runs, for an end-to-end metric
    read from the device over a whole timed window: each call under a
    profiler session of its own that records the device's activity
    alone (kernels, copies, sets; no host operations), so that no one
    session's buffers hold a whole window's launches. The sessions are
    reduced by ``busy_s`` once the window has closed; the calls run one
    after another, so their busy times add."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.sessions = []

    def run(self, call: Callable[[], dict]) -> dict:
        import torch

        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            out = call()
            self.sync()
        self.sessions.append(prof)
        return out

    @staticmethod
    def _intervals(prof) -> List[Tuple[float, float]]:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        res = getattr(prof.profiler, "kineto_results", None)
        if res is not None and hasattr(res, "events"):
            return [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns())
                     * 1e-9) for e in res.events()
                    if e.device_type() == cuda and not e.is_user_annotation()]
        return [(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events() if e.device_type == cuda
                and not getattr(e, "is_user_annotation", False)]

    def busy_s(self) -> float:
        total = 0.0
        for prof in self.sessions:
            total += sum(b - a for a, b in union(self._intervals(prof)))
        self.sessions = []
        return total


def profile(fn: Callable[[], None], sync: Callable[[], None]) -> TraceWindow:
    """Run ``fn`` (a few calls, ending on the host with their results)
    under the profiler, device and host, and reduce the trace."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ops, host, ranges, launches = [], [], {}, 0
    issued, corr = {}, []
    for e in prof.events():
        tr = e.time_range
        a, b = tr.start * 1e-6, tr.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                ranges.setdefault(e.name, []).append((a, b))
            else:
                ops.append((a, b, e.name))
                corr.append(getattr(e, "linked_correlation_id", 0))
        else:
            if e.name in LAUNCH_NAMES:
                launches += 1
            if e.name.startswith(("cuda", "cu")):
                issued[e.id] = a
            host.append((a, b, e.name))
    return TraceWindow(ops, ranges, host, launches, wall,
                       [issued.get(c) if c else None for c in corr])
