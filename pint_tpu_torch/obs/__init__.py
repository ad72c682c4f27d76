"""Structured telemetry for the dispatch stack (a copy of pint_tpu/obs:
the tracer, the histograms, the flight recorder, the metric registry,
and the numerical-health, performance-attribution and SLO planes).

Three pieces, one process-global instance of each:

- ``obs.tracer`` — span tracing with causal ids (supervisor retry/
  timeout/breaker/failover/drift children under each dispatch span),
  ring-buffered, Chrome trace-event export, JSONL stream mode;
- ``obs.hist`` — log-bucketed latency histograms (p50/p90/p99/max,
  power-of-two buckets, no per-sample storage);
- ``obs.flight`` — the flight recorder: the span ring dumped to
  ``$PINT_TPU_FLIGHT_DIR`` on breaker-open and other incidents;

and ``obs.metrics``, the process-global typed registry the
supervisor's counters live in, which three planes read and write:
``obs.health`` (health vectors, shadow drift, ``numerics:<reason>``
incidents), ``obs.perf`` (the compile ledger, rooflines, the dispatch
wall decomposition, profiler windows) and ``obs.slo`` (the burn-rate
watchdog).

The module-level helpers below are THE instrumentation surface the
rest of the port uses — ``span()``/``event()`` ask ``Tracer.active``
(the tracer's bool, then torch's profiler flag) before allocating
anything, so with tracing off ($PINT_TPU_TRACE unset, no stream, no
flight dir) and no profiler session open every instrumentation point
costs one method call and a branch. An open ``torch.profiler``
session turns recording on for its life: the spans land in the ring
and, on a thread the profiler records, in its trace as
``record_function`` ranges of the same name, on the profiler's
real-time axis (``obs.tracer``).

Configuration is lazy: the first use reads ``config.trace_enabled``
/ ``trace_stream_path`` / ``flight_dir`` / ``trace_ring_size``;
``configure()`` overrides explicitly and ``reset()`` drops back to
env-driven state. Everything here is pure stdlib.
"""

from __future__ import annotations

from pint_tpu_torch.runtime import locks
from typing import Optional

from pint_tpu_torch.obs import health  # noqa: F401
from pint_tpu_torch.obs import metrics  # noqa: F401
from pint_tpu_torch.obs import perf  # noqa: F401
from pint_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from pint_tpu_torch.obs.hist import HistogramSet, LatencyHistogram  # noqa: F401
from pint_tpu_torch.obs.tracer import (  # noqa: F401
    NOOP_SPAN,
    SpanHandle,
    Tracer,
    attach,
    current,
)

__all__ = ["Tracer", "SpanHandle", "LatencyHistogram",
           "HistogramSet", "FlightRecorder", "metrics", "health",
           "perf", "get_tracer",
           "get_flight", "configure", "reset", "span", "open_span",
           "open_root", "event", "record_span", "current", "attach",
           "flight_dump", "status", "export"]

_LOCK = locks.make_lock("obs.global")
_TRACER: Optional[Tracer] = None
_FLIGHT: Optional[FlightRecorder] = None
_CONFIGURED = False


def _ensure():
    """Build the global tracer/flight pair from config on first use
    (or return the explicitly configured ones)."""
    global _TRACER, _FLIGHT, _CONFIGURED
    if _TRACER is not None:
        return
    with _LOCK:
        if _TRACER is not None:
            return
        from pint_tpu_torch import config

        fdir = config.flight_dir()
        # an armed flight recorder needs a populated ring even when
        # trace export is off — recording is cheap, an empty black
        # box is useless
        tracer = Tracer(ring_size=config.trace_ring_size(),
                        recording=config.trace_enabled()
                        or fdir is not None,
                        stream=config.trace_stream_path())
        _TRACER = tracer
        _FLIGHT = FlightRecorder(fdir, tracer) if fdir else None
        _CONFIGURED = False


def get_tracer() -> Tracer:
    _ensure()
    return _TRACER


def get_flight() -> Optional[FlightRecorder]:
    _ensure()
    return _FLIGHT


def configure(enabled: Optional[bool] = None,
              stream=None, flight_dir=None,
              ring_size: Optional[int] = None) -> Tracer:
    """Explicitly (re)build the global tracer/flight pair — the
    daemon's CLI flags and tests. Omitted (None) arguments fall back
    to the env/config defaults; pass ``stream=False`` /
    ``flight_dir=False`` to FORCE them off regardless of env (the
    bench overhead measurement needs a genuinely-off tracer even in
    a deployment with a stream or flight recorder armed)."""
    global _TRACER, _FLIGHT, _CONFIGURED
    from pint_tpu_torch import config

    with _LOCK:
        if _TRACER is not None:
            _TRACER.close()
        if flight_dir is None:
            flight_dir = config.flight_dir()
        elif flight_dir is False:
            flight_dir = None
        if stream is None:
            stream = config.trace_stream_path()
        elif stream is False:
            stream = None
        recording = config.trace_enabled() if enabled is None \
            else bool(enabled)
        tracer = Tracer(
            ring_size=config.trace_ring_size()
            if ring_size is None else ring_size,
            recording=recording or flight_dir is not None
            or stream is not None,
            stream=stream)
        _TRACER = tracer
        _FLIGHT = FlightRecorder(flight_dir, tracer) \
            if flight_dir else None
        _CONFIGURED = True
        return tracer


def reset():
    """Drop the global instances; the next use re-reads the env
    (tests: a configured tracer must never leak across tests). Also
    stops the SLO watchdog, swaps in a fresh metric registry, drops the
    health monitor, the perf plane, the scoreboard's rows and the
    lock-order graph — the same isolation contract: consumers built
    before the reset keep their old bound children, fresh consumers
    register fresh."""
    global _TRACER, _FLIGHT, _CONFIGURED
    with _LOCK:
        if _TRACER is not None:
            _TRACER.close()
        _TRACER = None
        _FLIGHT = None
        _CONFIGURED = False
    from pint_tpu_torch.obs import slo

    slo.reset()
    metrics.reset()
    # the health monitor holds bound registry children and env-derived
    # thresholds: the same staleness hazard as the tracer
    health.reset()
    # the perf plane (compile ledger, profiler windows, decomposition
    # arming cache) and the global scoreboard's registry-shared rows
    # hold bound children of the registry just swapped
    perf.reset()
    from pint_tpu_torch import profiling

    profiling.scoreboard.reset()
    from pint_tpu_torch.runtime import locks as _locks

    _locks.reset()


# ------------------------------------------------------------------
# the instrumentation surface (hot-path cheap when off)
# ------------------------------------------------------------------


def span(name: str, parent=None, trace=None, **attrs):
    """Context-managed span under the current context (see
    ``Tracer.span``); the shared no-op when tracing is off and no
    profiler session is open."""
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    if not t.active():
        return NOOP_SPAN
    return t.span(name, parent=parent, trace=trace, **attrs)


def open_span(name: str, parent=None, trace=None, at=None, **attrs):
    """Open a held span (ends explicitly; see ``Tracer.open_span``)."""
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    if not t.active():
        return NOOP_SPAN
    return t.open_span(name, parent=parent, trace=trace, at=at, **attrs)


def open_root(name: str, label: str = "t", **attrs):
    """Open a ROOT span of a FRESH trace (the serve request root at
    admission, a device fit) — never parented under ambient context.
    """
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    if not t.active():
        return NOOP_SPAN
    return t.open_span(name, trace=t.new_trace(label), **attrs)


def event(name: str, **attrs):
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    if t.active():
        t.record_event(name, **attrs)


def record_span(name: str, t0_us: float, t1_us: float, parent=None,
                trace=None, **attrs):
    """A retroactive span from two stamps on the ring's axis
    (``Tracer.perf_us``/``monotonic_us``)."""
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    if t.active():
        t.record_span(name, t0_us, t1_us, parent=parent, trace=trace,
                      **attrs)


def recording() -> bool:
    """True while spans are recorded: the tracer is on, or a profiler
    session is open."""
    t = _TRACER
    if t is None:
        _ensure()
        t = _TRACER
    return t.active()


def flight_dump(reason: str, **extra) -> Optional[str]:
    """Trigger a flight-recorder dump (no-op when no flight dir is
    armed). Never raises — incident paths call this."""
    f = get_flight()
    if f is None:
        return None
    return f.dump(reason, **extra)


def export(path: str, base_us: float = 0.0) -> int:
    """Export the global tracer's ring as Chrome trace-event JSON (see
    ``Tracer.export`` for ``base_us``)."""
    return get_tracer().export(path, base_us)


def status() -> dict:
    """The ``obs`` block every snapshot embeds: tracer state,
    flight-recorder state and the perf plane's cheap status (ledger
    counts, profiler window state)."""
    t = get_tracer()
    out = {"trace": t.status()}
    f = get_flight()
    out["flight"] = f.status() if f is not None else None
    try:
        out["perf"] = perf.status()
    except Exception:
        pass
    return out
