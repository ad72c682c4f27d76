"""Process-global typed metric registry + Prometheus exposition (a
copy of pint_tpu/obs/metrics.py; the metric names are the
reference's, so one scrape reads the same in both packages).

Before this module the serve/dispatch stack's counters lived in four
private snapshot dicts (``RuntimeMetrics``, ``ServeMetrics``, the
admission controller, the capacity router), visible only at
``stop()``/bench time — a latency regression or shed creep was
invisible until a breaker opened or a human read an artifact, and
the multi-worker fleet of ROADMAP item 3 has no pull surface at all.
This module is the metrics *plane* those consumers now write
through:

- **typed metrics**: ``Counter`` (monotonic), ``Gauge`` (set/pull),
  ``Histogram`` (rows are ``obs.hist.LatencyHistogram`` — the same
  power-of-two buckets, O(1) memory, upper-edge quantiles). Every
  metric holds one value per LABEL SET (``(pool, kind, shape_class)``
  on the serve histograms, ``scope`` everywhere an engine-local
  counter must stay distinguishable from another engine's);
- **derived views**: the existing ``snapshot()`` dicts of the
  supervisor/admission/router/serve layers are now read THROUGH
  bound registry children, so artifact blocks stay bit-compatible
  while the registry is the single source of truth (parity asserted
  by tests/test_metrics.py and the chaos oracle);
- **exposition**: ``render()`` emits Prometheus text format 0.0.4
  (`# HELP`/`# TYPE`, cumulative ``_bucket{le=...}`` rows for
  histograms); ``MetricsServer`` serves it on ``/metrics`` plus a
  ``/healthz`` breaker/pool-state JSON from a stdlib ``http.server``
  daemon thread — and NEVER takes an engine lock (the fleet-
  readiness contract: a scrape must not perturb admission or an
  in-flight drain; registry reads hold only per-metric locks);
- **process scope**: one registry per process (``get_registry``),
  ``reset()`` swaps in a fresh one for test isolation (the
  ``obs.reset()`` pattern — consumers built before the reset keep
  mutating their old bound children, invisible to the new registry,
  exactly like a reconfigured tracer).

Everything here is pure stdlib (the breaker layer keeps the same
property); the one torch touch, ``sample_device_memory``, refuses to
INITIALIZE CUDA (it reads the allocator only when CUDA is already
initialized: a scrape must never start a device context).
"""

from __future__ import annotations

import itertools
import json
import re
import threading

from pint_tpu_torch.runtime import locks
from typing import Callable, Dict, List, Optional, Tuple

from pint_tpu_torch.obs.hist import LatencyHistogram

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "MetricsServer", "get_registry", "counter", "gauge",
           "histogram", "new_scope", "reset", "render",
           "default_health", "sample_device_memory"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")

# scope ids are process-monotonic and survive registry resets, so an
# instance built before a reset() can never collide with one built
# after (same reason tracer trace-ids never reset mid-process)
_SCOPE_IDS = itertools.count(1)


def new_scope(prefix: str) -> str:
    """Unique per-instance scope label value (``sup3``, ``adm7``):
    several engines coexist in one process, each with self-contained
    accounting, while the registry stays process-global."""
    return f"{prefix}{next(_SCOPE_IDS)}"


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                extra: Optional[List[Tuple[str, str]]] = None) -> str:
    items = list(key) + list(extra or [])
    if not items:
        return ""
    parts = []
    for k, v in items:
        k = _LABEL_BAD.sub("_", k)
        v = v.replace("\\", r"\\").replace('"', r'\"') \
             .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Bound:
    """A metric bound to one label set — the hot-path handle the
    supervisor/serve counters hold, so a bump is one lock + one dict
    write with the label key pre-computed."""

    __slots__ = ("metric", "key")

    def __init__(self, metric, key):
        self.metric = metric
        self.key = key

    def inc(self, n: float = 1):
        self.metric._inc(self.key, n)

    def set(self, v: float):
        self.metric._set(self.key, v)

    def value(self) -> float:
        return self.metric._get(self.key)


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = _NAME_BAD.sub("_", name)
        self.help = help
        self._lock = locks.make_plane_lock("obs.metric")
        self._vals: Dict[tuple, float] = {}

    def child(self, **labels) -> _Bound:
        key = _label_key(labels)
        with self._lock:
            self._vals.setdefault(key, 0.0)
        return _Bound(self, key)

    def _inc(self, key, n):
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def _set(self, key, v):
        with self._lock:
            self._vals[key] = float(v)

    def _get(self, key) -> float:
        with self._lock:
            return self._vals.get(key, 0.0)

    # -- views ---------------------------------------------------------

    def series(self) -> List[Tuple[tuple, float]]:
        with self._lock:
            return sorted(self._vals.items())

    def value(self, **labels) -> float:
        return self._get(_label_key(labels))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._vals.values()))


class Counter(Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels):
        self._inc(_label_key(labels), n)

    def _set(self, key, v):  # counters are monotonic by contract
        raise TypeError(f"counter {self.name} cannot be set()")


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._fns: Dict[tuple, Callable[[], Optional[float]]] = {}

    def set(self, v: float, **labels):
        self._set(_label_key(labels), v)

    def set_max(self, v: float, **labels):
        """Watermark semantics: keep the max ever observed."""
        key = _label_key(labels)
        with self._lock:
            if float(v) > self._vals.get(key, float("-inf")):
                self._vals[key] = float(v)

    def set_fn(self, fn: Callable[[], Optional[float]], **labels):
        """Pull gauge: ``fn`` is evaluated at collection time
        (guarded — a dead producer yields no sample, never an
        exposition failure). The jit-cache-size gauge pattern."""
        with self._lock:
            self._fns[_label_key(labels)] = fn

    def series(self) -> List[Tuple[tuple, float]]:
        with self._lock:
            fns = list(self._fns.items())
        for key, fn in fns:
            try:
                v = fn()
            except Exception:
                v = None
            if v is not None:
                self._set(key, float(v))
            else:
                # a dead producer (weakref gone, feature absent)
                # must STOP exporting, not freeze its last sample —
                # the fn stays registered so a transient None (e.g.
                # a jit cache not yet built) can resume later
                with self._lock:
                    self._vals.pop(key, None)
        return super().series()


class Histogram(Metric):
    """Labelled histogram whose rows ARE ``LatencyHistogram``
    objects. ``row(**labels)`` hands the shared row out — the
    ``HistogramSet`` views of the supervisor/serve layers store the
    SAME objects, so the registry and the snapshot blocks can never
    disagree (parity by construction, not by double bookkeeping)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._rows: Dict[tuple, LatencyHistogram] = {}

    def row(self, **labels) -> LatencyHistogram:
        key = _label_key(labels)
        h = self._rows.get(key)
        if h is None:
            with self._lock:
                h = self._rows.setdefault(key, LatencyHistogram())
        return h

    def observe(self, seconds: float, **labels):
        self.row(**labels).record(seconds)

    def rows(self) -> List[Tuple[tuple, LatencyHistogram]]:
        with self._lock:
            return sorted(self._rows.items())

    def series(self) -> List[Tuple[tuple, float]]:
        return [(key, float(h.count)) for key, h in self.rows()]

    def matching(self, labels: dict) -> List[LatencyHistogram]:
        """Rows whose label set CONTAINS ``labels`` (the SLO
        watchdog's selector: sum e2e buckets across classes/pools
        for one kind)."""
        want = set(_label_key(labels))
        return [h for key, h in self.rows() if want <= set(key)]


class MetricRegistry:
    """Name -> typed metric, get-or-create with type checking."""

    _KINDS = {"counter": Counter, "gauge": Gauge,
              "histogram": Histogram}

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = locks.make_plane_lock("obs.registry")

    def _get(self, cls, name: str, help: str) -> Metric:
        name = _NAME_BAD.sub("_", name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{m.kind}, requested {cls.kind}")
            elif help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return sorted(self._metrics.values(),
                          key=lambda m: m.name)

    # -- convenience reads (tests, SLO, stats views) -------------------

    def value(self, name: str, **labels) -> float:
        m = self.get(name)
        return 0.0 if m is None else m.value(**labels)

    def total(self, name: str) -> float:
        m = self.get(name)
        return 0.0 if m is None else m.total()

    # -- exposition ----------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4. Histograms emit
        cumulative ``_bucket{le=...}`` rows at the log2 upper edges
        (seconds), plus ``_sum``/``_count`` — rebuildable into any
        quantile with the one-octave bound of ``obs.hist``."""
        lines: List[str] = []
        for m in self.collect():
            if m.help:
                h = m.help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {m.name} {h}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, row in m.rows():
                    snap_counts, count, sum_s = _hist_state(row)
                    acc = 0
                    for k in sorted(snap_counts):
                        acc += snap_counts[k]
                        le = (1 << k) / 1e6 if k else 1e-6
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(key, [('le', repr(le))])}"
                            f" {acc}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(key, [('le', '+Inf')])}"
                        f" {count}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                                 f"{repr(float(sum_s))}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} "
                                 f"{count}")
            else:
                for key, v in m.series():
                    lines.append(
                        f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Compact JSON-able registry view (the daemon's inline
        ``stats`` answer and the dryrun's metrics block): per metric
        the type and either the labelled series (counter/gauge) or
        count/p99 per row (histogram)."""
        out: dict = {}
        for m in self.collect():
            if isinstance(m, Histogram):
                rows = {}
                for key, h in m.rows():
                    s = h.snapshot()
                    rows["/".join(v for _, v in key) or "_"] = {
                        "count": s.get("count", 0),
                        "p99_ms": s.get("p99_ms"),
                    }
                out[m.name] = {"type": m.kind, "rows": rows}
            else:
                out[m.name] = {"type": m.kind, "series": {
                    "/".join(v for _, v in key) or "_": v
                    for key, v in m.series()}}
        return out


def _hist_state(row: LatencyHistogram):
    with row._lock:
        return dict(row.counts), row.count, row.sum_s


# ------------------------------------------------------------------
# the process-global registry
# ------------------------------------------------------------------

_REG: Optional[MetricRegistry] = None
_REG_LOCK = locks.make_plane_lock("obs.registry_global")


def get_registry() -> MetricRegistry:
    global _REG
    if _REG is None:
        with _REG_LOCK:
            if _REG is None:
                _REG = MetricRegistry()
    return _REG


def counter(name: str, help: str = "") -> Counter:
    return get_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return get_registry().gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return get_registry().histogram(name, help)


def render() -> str:
    return get_registry().render()


def reset():
    """Swap in a fresh registry (tests: the ``obs.reset()``
    isolation contract — consumers built before the reset keep their
    old bound children; fresh consumers register fresh)."""
    global _REG
    with _REG_LOCK:
        _REG = MetricRegistry()


# ------------------------------------------------------------------
# device-memory watermark
# ------------------------------------------------------------------


def sample_device_memory() -> Optional[int]:
    """Bytes the CUDA caching allocator holds for live tensors
    (``torch.cuda.memory_allocated()``), recorded into the
    ``pint_tpu_device_memory_watermark_bytes`` gauge (max-ever
    semantics). Returns the current total, or None when CUDA is not
    initialized in this process.

    NEVER initializes CUDA: it reads the allocator only when
    ``torch.cuda.is_initialized()`` is already true, and never
    imports torch itself (a process that has not imported torch has
    no device memory to report), so a metrics scrape cannot start a
    device context in the process it is observing."""
    import sys

    try:
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return None
        total = int(torch.cuda.memory_allocated())
        gauge("pint_tpu_device_memory_watermark_bytes",
              "peak live accelerator buffer bytes").set_max(total)
        return total
    except Exception:
        return None


# ------------------------------------------------------------------
# exposition server
# ------------------------------------------------------------------


def default_health() -> dict:
    """Breaker states, the SLO watchdog and the numerical-health
    verdict with NO engine lock: breaker snapshots hold only the
    per-breaker lock, the SLO status its ring lock, the health block
    the monitor's lock."""
    out: dict = {"ok": True}
    try:
        from pint_tpu_torch.runtime import supervisor as _sup

        brs = {b: br.snapshot()
               for b, br in dict(_sup._BREAKERS).items()}
        out["breakers"] = brs
        out["ok"] = not any(s.get("state") == "open"
                            for s in brs.values())
    except Exception as e:  # breakers unavailable != unhealthy
        out["breakers_error"] = repr(e)
    try:
        from pint_tpu_torch.obs import slo as _slo

        w = _slo.get_watchdog()
        if w is not None:
            out["slo"] = w.status()
    except Exception:
        pass
    try:
        # the worst recent verdict per (pool, kind) and the last
        # incident: an armed monitor with an unresolved incident
        # degrades /healthz to 503 the way an open breaker does
        from pint_tpu_torch.obs import health as _health

        h = _health.status()
        if h is not None:
            out["numerics"] = h
            if any(not v.get("ok", True)
                   for v in h.get("worst", {}).values()):
                out["ok"] = False
    except Exception:
        pass
    return out


class MetricsServer:
    """``/metrics`` + ``/healthz`` on a stdlib daemon thread.

    ``port=0`` binds an ephemeral port (tests); ``health_fn``
    overrides the default breaker-state payload (the daemon passes
    one that adds its engine's pool states — all lock-free reads).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricRegistry] = None,
                 health_fn: Optional[Callable[[], dict]] = None):
        import http.server

        reg = registry  # bound into the handler closure

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        sample_device_memory()
                        body = (reg or get_registry()).render() \
                            .encode("utf-8")
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/healthz":
                        h = (health_fn or default_health)()
                        body = json.dumps(h, default=str) \
                            .encode("utf-8")
                        self._send(200 if h.get("ok") else 503,
                                   body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:  # scrape must never kill us
                    try:
                        self._send(500, repr(e).encode(),
                                   "text/plain")
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name=f"pint-metrics-{self.port}")
            self._thread.start()
        return self

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread = None
