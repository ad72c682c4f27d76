"""Serving metrics: per-bucket counters surfaced through the existing
profiling layer.

``profiling.Scoreboard`` already accumulates named wall-clock phases
process-wide; the serve layer feeds it (``serve.assemble`` /
``serve.dispatch`` annotations ride ``profiling.annotate``, so they
show up in device traces too) and adds the serving-specific view a
scoreboard cannot express: queue depth, batch occupancy, padded-waste
fraction, per-bucket latency quantiles, compile counts.

Everything here is host bookkeeping — a few dict updates per BATCH,
not per TOA — so it stays on unconditionally (same design stance as
``FitStats``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["BucketStats", "ServeMetrics", "percentile"]

# per-bucket latency reservoir cap: enough for stable p99 at serving
# rates while bounding memory on a long-lived engine (newest kept —
# serving cares about current behavior, not the cold start)
_LAT_CAP = 4096


def percentile(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (no numpy
    dependency on the hot path; empty -> nan)."""
    if not sorted_xs:
        return float("nan")
    k = min(len(sorted_xs) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_xs) - 1)))))
    return sorted_xs[k]


def _pct_ms(sorted_xs: List[float], q: float) -> Optional[float]:
    """percentile in ms for a JSON snapshot: None (valid JSON null)
    when there are no samples — json.dumps would otherwise emit the
    bare NaN token, which strict parsers reject."""
    if not sorted_xs:
        return None
    return round(percentile(sorted_xs, q) * 1e3, 3)


class BucketStats:
    """Counters for one shape class (one executable) — registry-
    backed: each stat is a bound child of the
    ``pint_tpu_serve_bucket_*_total`` counters labelled
    (scope, cls), read back through ``__getattr__`` so the snapshot
    stays a derived view. The latency reservoir is per-sample state,
    not a counter, and stays local."""

    _COUNTERS = ("requests", "batches", "slots", "rows_real",
                 "rows_padded")

    def __init__(self, scope: str = "", cls: str = ""):
        from pint_tpu_torch.obs import metrics as om

        self._c = {
            name: om.counter(
                f"pint_tpu_serve_bucket_{name}_total",
                f"per-shape-class {name.replace('_', ' ')}"
            ).child(scope=scope, cls=cls)
            for name in self._COUNTERS}
        self.latencies_s: List[float] = []  # admit -> future resolved

    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in type(self)._COUNTERS:
            return int(c[name].value())
        raise AttributeError(name)

    def record(self, nreal: int, pb: int, rows_real: int,
               rows_padded: int, lats: List[float]):
        self._c["requests"].inc(nreal)
        self._c["batches"].inc()
        self._c["slots"].inc(pb)
        self._c["rows_real"].inc(rows_real)
        self._c["rows_padded"].inc(rows_padded)
        self.latencies_s.extend(lats)
        if len(self.latencies_s) > _LAT_CAP:
            del self.latencies_s[:-_LAT_CAP]

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch slots holding real requests."""
        return self.requests / self.slots if self.slots else 0.0

    @property
    def padded_waste(self) -> float:
        """Fraction of dispatched rows that were padding."""
        tot = self.rows_padded
        return 1.0 - self.rows_real / tot if tot else 0.0

    def snapshot(self) -> dict:
        lats = sorted(self.latencies_s)
        return {
            "requests": self.requests, "batches": self.batches,
            "occupancy": round(self.occupancy, 4),
            "padded_waste": round(self.padded_waste, 4),
            "p50_ms": _pct_ms(lats, 50),
            "p99_ms": _pct_ms(lats, 99),
        }


class ServeMetrics:
    """Engine-wide serving counters + the per-bucket table.

    ``cache`` is the engine's ExecutableCache — compile counts are
    read from it live so the metrics can never disagree with the
    thing that actually compiled."""

    def __init__(self, cache=None, supervisor=None,
                 pipeline_depth: int = 1, donation: bool = False,
                 admission=None, router=None):
        self.cache = cache
        self.supervisor = supervisor
        self.pipeline_depth = pipeline_depth   # configured in-flight cap
        self.donation = donation               # buffer donation on?
        # observability: the admission controller's shed
        # counters, the capacity router's per-pool shares, and the
        # engine's restart provenance ride every snapshot — a shed,
        # rerouted or replayed request is always visible in the
        # artifact, never a silent drop
        self.admission = admission
        self.router = router
        self.append_store = None   # wired by the engine
        self.restart_info: dict = {}
        # log-bucketed latency histograms per (pool, kind, class) x
        # (queue_wait | dispatch_wall | e2e) — fixed power-of-two
        # buckets, O(1) memory, p50/p90/p99/max without per-sample
        # storage. The per-bucket reservoir above remains
        # the exact-quantile view of RECENT traffic; this is the
        # unbounded-horizon tail view the artifacts embed. # rows are SHARED with the registry's
        # pint_tpu_serve_latency_seconds histogram and the engine
        # counters are bound registry children (scope-labelled), so
        # snapshot() is a derived view of the metrics plane.
        from pint_tpu_torch.obs import HistogramSet
        from pint_tpu_torch.obs import metrics as om

        self.scope = om.new_scope("serve")
        hist = om.histogram(
            "pint_tpu_serve_latency_seconds",
            "serve latency per (pool, kind, class) x "
            "(queue_wait|dispatch_wall|e2e)")
        scope = self.scope
        self.latency = HistogramSet(
            row_factory=lambda key, metric: hist.row(
                scope=scope, pool=str(key[0]), kind=str(key[1]),
                cls=str(key[2]) if len(key) > 2 else "",
                metric=metric))
        self._c = {
            name: om.counter(
                f"pint_tpu_serve_{name}_total",
                f"serve engine {name.replace('_', ' ')}"
            ).child(scope=scope)
            for name in self._COUNTERS}
        self._g_queue = om.gauge("pint_tpu_serve_queue_depth",
                                 "admitted-and-undispatched "
                                 "requests").child(scope=scope)
        self._g_queue_max = om.gauge(
            "pint_tpu_serve_max_queue_depth",
            "peak queue depth").child(scope=scope)
        self.max_queue_depth = 0
        self._queue_depth = 0
        self.buckets: Dict[tuple, BucketStats] = {}

    # "attempts" counts every submit() entry BEFORE any shed
    # decision: quota and overload sheds never
    # reach the `submitted` counter, so a shed-rate SLO with
    # `submitted` as denominator would be blind to a pure-shed
    # storm — attempts is the honest denominator
    _COUNTERS = ("attempts", "submitted", "completed", "rejected",
                 "deadline_missed", "fallback_single", "failed")

    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in type(self)._COUNTERS:
            return int(c[name].value())
        raise AttributeError(name)

    def bump(self, name: str, n: int = 1):
        """The ONE mutation surface for the engine counters."""
        self._c[name].inc(n)

    # -- gauges --------------------------------------------------------

    def queue_depth(self, depth: Optional[int] = None) -> int:
        if depth is not None:
            self._queue_depth = depth
            self._g_queue.set(depth)
            if depth > self.max_queue_depth:
                self.max_queue_depth = depth
                self._g_queue_max.set(depth)
        return self._queue_depth

    def bucket(self, key) -> BucketStats:
        if key not in self.buckets:
            self.buckets[key] = BucketStats(
                scope=self.scope, cls=self._fmt_key(key))
        return self.buckets[key]

    @property
    def compile_count(self) -> int:
        return self.cache.compile_count if self.cache else 0

    @property
    def bucket_count(self) -> int:
        """Distinct shape classes admitted — the bound the executable
        count must respect."""
        return len(self.buckets)

    # -- reporting -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able state of the engine (the daemon prints this on
        shutdown; bench_serve embeds it in its artifact)."""
        all_lats = sorted(
            x for b in self.buckets.values() for x in b.latencies_s)
        slots = sum(b.slots for b in self.buckets.values())
        reqs = sum(b.requests for b in self.buckets.values())
        rows_r = sum(b.rows_real for b in self.buckets.values())
        rows_p = sum(b.rows_padded for b in self.buckets.values())
        out = {
            "attempts": self.attempts,
            "submitted": self.submitted, "completed": self.completed,
            "rejected": self.rejected,
            "deadline_missed": self.deadline_missed,
            "fallback_single": self.fallback_single,
            "failed": self.failed,
            "queue_depth": self._queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "compile_count": self.compile_count,
            "bucket_count": self.bucket_count,
            "batch_occupancy": round(reqs / slots, 4) if slots else 0.0,
            "padded_waste": round(1.0 - rows_r / rows_p, 4)
            if rows_p else 0.0,
            "p50_ms": _pct_ms(all_lats, 50),
            "p99_ms": _pct_ms(all_lats, 99),
            "per_bucket": {self._fmt_key(k): b.snapshot()
                           for k, b in sorted(self.buckets.items(),
                                              key=lambda kv: str(kv[0]))},
        }
        # the pipeline/donation configuration rides the snapshot so
        # an artifact can say how a number was produced (the
        # dispatch_overhead observability contract)
        out["pipeline_depth"] = self.pipeline_depth
        out["donation"] = bool(self.donation)
        # latency histograms + tracer/flight state — the
        # `latency` and `obs` blocks every serve artifact carries
        out["latency"] = self.latency.snapshot()
        from pint_tpu_torch import obs

        out["obs"] = obs.status()
        # the annotate()/phase scoreboard is registry-
        # backed now — its rows (serve.assemble, serve.dispatch)
        # ride the snapshot instead of living in a report-only dict
        try:
            from pint_tpu_torch.profiling import scoreboard

            sb = scoreboard.snapshot()
            if sb:
                out["scoreboard"] = sb
        except Exception:
            pass
        # the SLO watchdog's burn state rides the snapshot
        # when armed ($PINT_TPU_SLO) — absent otherwise, keeping the
        # pre-metrics-plane snapshot shape bit-compatible
        from pint_tpu_torch.obs import slo as _slo

        slo_state = _slo.status()
        if slo_state is not None:
            out["slo"] = slo_state
        # the numerical-health verdict block when the
        # monitor is armed ($PINT_TPU_HEALTH / $PINT_TPU_SHADOW_RATE)
        # — absent otherwise, keeping pre-health snapshots
        # bit-compatible (the slo-block convention)
        from pint_tpu_torch.obs import health as _hmon

        health_state = _hmon.status()
        if health_state is not None:
            out["health"] = health_state
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        if self.append_store is not None:
            # per-pulsar append-state accounting (cold
            # builds vs rank updates — the warm/cold serving mix)
            out["append"] = self.append_store.snapshot()
        if self.router is not None:
            out["router"] = self.router.snapshot()
        if self.restart_info:
            rs = dict(self.restart_info)
            aot = getattr(self.cache, "aot", None)
            if aot is not None:
                rs["aot"] = aot.snapshot()  # live, not ctor-time
            out["restart"] = rs
        if self.supervisor is not None:
            # the dispatch-supervisor counters (timeouts, retries,
            # breaker state, failovers; max_inflight = the pipelining
            # actually achieved): a degraded run must be LABELED in
            # the artifact, never silently slow
            out["dispatch"] = self.supervisor.snapshot()
        return out

    @staticmethod
    def _fmt_key(key) -> str:
        return "/".join(str(x) for x in key)

    def report(self) -> str:
        """Human-readable table (mirrors Scoreboard.report's shape)."""
        s = self.snapshot()
        lines = [
            f"serve: {s['completed']}/{s['submitted']} completed, "
            f"{s['rejected']} rejected, {s['deadline_missed']} missed "
            f"deadline, {s['fallback_single']} single-fallback, "
            f"{s['failed']} failed",
            f"executables: {s['compile_count']} "
            f"(shape classes: {s['bucket_count']}), occupancy "
            f"{s['batch_occupancy']:.2f}, padded waste "
            f"{s['padded_waste']:.2f}, p50 {s['p50_ms']} ms, "
            f"p99 {s['p99_ms']} ms",
            f"{'bucket':<28} {'reqs':>6} {'batch':>6} {'occ':>6} "
            f"{'waste':>6} {'p50ms':>8} {'p99ms':>8}",
        ]
        adm = s.get("admission")
        if adm and (adm.get("shed_expired") or adm.get("shed_quota")
                    or adm.get("shed_deadline")
                    or adm.get("shed_shutdown")):
            lines.insert(1, (
                f"SHED: {adm['shed_expired']} expired in queue, "
                f"{adm['shed_deadline']} deadline-doomed, "
                f"{adm['shed_quota']} over tenant quota, "
                f"{adm['shed_shutdown']} at shutdown "
                f"(policy {adm['policy']})"))
        rt = s.get("router")
        if rt and rt.get("host", {}).get("dispatches"):
            lines.insert(1, (
                f"pools: device {rt['device']['dispatches']} "
                f"dispatches ({rt['device']['share']:.0%}), host "
                f"{rt['host']['dispatches']} "
                f"({rt['host']['share']:.0%}, "
                f"{rt['host']['demotions']} breaker demotions)"))
        rs = s.get("restart")
        if rs and (rs.get("warm") or rs.get("replayed")):
            lines.insert(1, (
                f"restart: warm={rs.get('warm')} "
                f"aot_restored={rs.get('aot', {}).get('restored', 0)} "
                f"replayed={rs.get('replayed', 0)}"))
        disp = s.get("dispatch")
        if disp and (disp.get("timeouts") or disp.get("failovers")
                     or disp.get("retries")
                     or disp.get("breaker_rejections")):
            states = ", ".join(
                f"{b}:{v['state']}"
                for b, v in sorted(disp.get("breakers", {}).items()))
            lines.insert(2, (
                f"DEGRADED dispatch: {disp.get('failovers', 0)} "
                f"failovers, {disp.get('timeouts', 0)} timeouts, "
                f"{disp.get('retries', 0)} retries, "
                f"{disp.get('breaker_rejections', 0)} breaker "
                f"rejections ({states})"))
        for k, b in s["per_bucket"].items():
            lines.append(
                f"{k:<28} {b['requests']:>6} {b['batches']:>6} "
                f"{b['occupancy']:>6.2f} {b['padded_waste']:>6.2f} "
                f"{b['p50_ms']:>8} {b['p99_ms']:>8}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.snapshot())
