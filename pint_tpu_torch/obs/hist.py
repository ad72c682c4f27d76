"""Log-bucketed latency histograms: p50/p90/p99/max with no
per-sample storage.

The serve layer judged latency from a capped per-bucket reservoir
(sort + nearest-rank at snapshot time) and the router from EWMA
rates — fine for means, blind in the tail and unbounded-ish in
memory. Here every sample lands in a FIXED power-of-two bucket:
bucket ``k`` covers [2^(k-1), 2^k) microseconds, so ~41 buckets span
1 us to ~20 minutes, memory is O(1) per (pool, kind, class, metric)
row regardless of traffic, and recording is an integer bit_length +
one dict bump under a short lock. Quantiles are read by cumulative
walk and reported at the bucket's UPPER edge — a conservative bound
with at most one-octave (2x) resolution error, which is the right
trade for judging SLO tails ("p99 is under 8 ms" is actionable;
"p99 is 6.1 vs 6.3 ms" never is).

``HistogramSet`` is the keyed table the serve scheduler feeds per
(pool, kind, shape-class) x metric (queue_wait / dispatch_wall /
e2e), embedded as the ``latency`` block of ``ServeMetrics.snapshot``
and the bench artifacts; the dispatch supervisor keeps a per-key set
for non-serve callers (device fits, PTA solves).
"""

from __future__ import annotations

from pint_tpu_torch.runtime import locks
from typing import Dict, Optional, Tuple

__all__ = ["LatencyHistogram", "HistogramSet"]

# bucket k covers [2^(k-1), 2^k) us; k=0 is the sub-microsecond bin.
# 41 buckets reach 2^40 us ~ 12.7 days — nothing a serving process
# measures can overflow it, and overflow clamps to the top bucket.
_MAX_BUCKET = 41


def _bucket_of(us: float) -> int:
    # not (us >= 1.0) also catches NaN; the top-bucket clamp catches
    # inf BEFORE int() (int(inf) raises OverflowError — a garbage
    # sample must clamp, never crash the recording thread)
    if not (us >= 1.0):
        return 0
    if us >= float(1 << _MAX_BUCKET):
        return _MAX_BUCKET
    return min(_MAX_BUCKET, int(us).bit_length())


def _upper_edge_ms(k: int) -> float:
    """Upper edge of bucket k in milliseconds."""
    return (1 << k) / 1e3 if k else 1e-3


class LatencyHistogram:
    """One metric's fixed-bucket histogram. ``record`` takes seconds
    (the unit every wall in this repo is measured in)."""

    __slots__ = ("counts", "count", "sum_s", "max_s", "_lock")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self._lock = locks.make_plane_lock("obs.hist_row")

    def record(self, seconds: float):
        if not (seconds >= 0.0):   # negative AND NaN clamp to zero
            seconds = 0.0
        k = _bucket_of(seconds * 1e6)
        with self._lock:
            self.counts[k] = self.counts.get(k, 0) + 1
            self.count += 1
            self.sum_s += seconds
            if seconds > self.max_s:
                self.max_s = seconds

    def quantile_ms(self, q: float) -> Optional[float]:
        """Upper-edge quantile in ms (nearest-rank over buckets);
        None when empty. q in [0, 100]."""
        with self._lock:
            if not self.count:
                return None
            rank = max(1, int(round(q / 100.0 * self.count)))
            acc = 0
            for k in sorted(self.counts):
                acc += self.counts[k]
                if acc >= rank:
                    return _upper_edge_ms(k)
            return _upper_edge_ms(max(self.counts))

    def snapshot(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            mean_ms = self.sum_s / self.count * 1e3
            buckets = {str(k): v
                       for k, v in sorted(self.counts.items())}
            count, max_s = self.count, self.max_s
        return {
            "count": count,
            "p50_ms": self.quantile_ms(50),
            "p90_ms": self.quantile_ms(90),
            "p99_ms": self.quantile_ms(99),
            "max_ms": round(max_s * 1e3, 3),
            "mean_ms": round(mean_ms, 3),
            # sparse log2 bucket table: key k counts samples in
            # [2^(k-1), 2^k) us — enough to rebuild any quantile
            "log2_us_buckets": buckets,
        }


class HistogramSet:
    """Keyed histogram table: one LatencyHistogram per
    (key..., metric) row, created on first record. Keys are joined
    with "/" in snapshots (the serve metrics key convention).

    ``row_factory(key, metric)`` lets the row objects be
    SHARED with a registry histogram (``obs.metrics.Histogram.row``)
    — both views then read the same LatencyHistogram, so the
    snapshot block and the /metrics exposition can never disagree."""

    def __init__(self, row_factory=None):
        self._rows: Dict[Tuple, LatencyHistogram] = {}
        self._lock = locks.make_plane_lock("obs.hist_set")
        self._factory = row_factory or \
            (lambda key, metric: LatencyHistogram())

    def record(self, key: Tuple, metric: str, seconds: float):
        row = (tuple(key), metric)
        h = self._rows.get(row)
        if h is None:
            with self._lock:
                h = self._rows.get(row)
                if h is None:
                    h = self._rows[row] = self._factory(row[0],
                                                        metric)
        h.record(seconds)

    def get(self, key: Tuple, metric: str) -> Optional[LatencyHistogram]:
        return self._rows.get((tuple(key), metric))

    def __len__(self):
        return len(self._rows)

    def snapshot(self) -> dict:
        """{key-string: {metric: histogram snapshot}}."""
        with self._lock:
            rows = dict(self._rows)
        out: dict = {}
        for (key, metric), h in sorted(rows.items(),
                                       key=lambda kv: (str(kv[0][0]),
                                                       kv[0][1])):
            ks = "/".join(str(x) for x in key)
            out.setdefault(ks, {})[metric] = h.snapshot()
        return out
