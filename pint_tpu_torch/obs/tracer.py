"""Span tracer: causal IDs, ring buffer, Chrome trace-event export.

SURVEY.md §5 names tracing a first-class requirement the reference
never had (loguru DEBUG lines in src/pint/toa.py / fitter.py are its
only visibility); after the async/pipelined/breaker/admission layers
of the reference flat counters can say *that* a request degraded but
never *what sequence of events led there*. This tracer makes a
DEGRADED artifact a replayable causal story:

- **spans** carry a trace id (assigned at serve admission, or fresh
  per fit), a span id, and a parent span id — parent/child links are
  explicit, so an exported trace can be walked bottom-up from any
  terminal span to the admission that caused it;
- **context propagation** rides a ``contextvars.ContextVar``: a span
  opened inside another's ``with`` block parents automatically, and
  ``attach(ctx)`` re-enters a captured context on another thread
  (the supervisor's async workers, the serve drain loop);
- **ring buffer**: completed records land in a bounded ring
  (``config.trace_ring_size``) under one short lock — a long-lived
  serving process never grows, and the ring IS the flight-recorder
  payload (``pint_tpu_torch.obs.flight``);
- **export** (``Tracer.export``) writes Chrome trace-event JSON
  ({"traceEvents": [...]}, "X" complete events + "i" instants) that
  loads in Perfetto / chrome://tracing; span/parent/trace ids ride
  the ``args`` of every event so causality survives the format;
- **stream mode**: with a JSONL stream attached every completed
  record is ALSO appended (one JSON object per line, flushed) as it
  completes — the ``pint_serve`` live-tail, crash-safe where the
  in-memory ring is not;
- **off by default**: ``recording`` is False unless $PINT_TPU_TRACE
  / a stream / an armed flight recorder turns it on, and the
  module-level ``span()``/``event()`` helpers return a shared no-op
  before allocating anything — the fault-free hot path pays one
  attribute read and a branch per instrumentation point (measured
  <1% on the north-star fit, bench.py ``obs`` block).

Timestamps are ``time.monotonic()`` microseconds against the
tracer's epoch — the same clock the serve layer stamps
``admitted_at`` with, so retroactive spans (queue-wait, recorded at
dispatch time from the admission stamp) land on the same axis.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading

from pint_tpu_torch.runtime import locks
import time
from typing import Optional

__all__ = ["Tracer", "SpanHandle", "current", "attach"]

# the active span context: (trace_id, span_id) of the innermost open
# span on this thread/task, or None outside any span
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "pint_tpu_obs_span", default=None)


def current():
    """(trace_id, span_id) of the innermost open span in this
    context, or None. Capture it on the issuing thread and re-enter
    with ``attach`` on a worker thread."""
    return _CURRENT.get()


class attach:
    """Re-enter a captured span context on another thread: spans
    opened inside the ``with`` block parent under ``ctx`` exactly as
    if they were opened where it was captured."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx):
        self.ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _CURRENT.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        return False


class SpanHandle:
    """One OPEN span. ``event()`` attaches instants under it,
    ``end()`` records the completed span into the ring. Usable as a
    context manager (``Tracer.span``) or held open across callbacks
    (the serve request root span ends at terminal resolution)."""

    __slots__ = ("tracer", "name", "trace_id", "span_id",
                 "parent_id", "t0", "attrs", "_ended", "_token")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 t0, attrs):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs
        self._ended = False
        self._token = None

    @property
    def ctx(self):
        return (self.trace_id, self.span_id)

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        """Instant event parented under this span."""
        self.tracer.record_event(name, trace_id=self.trace_id,
                                 parent_id=self.span_id, **attrs)
        return self

    def end(self, status: Optional[str] = None, **attrs):
        if self._ended:
            return
        self._ended = True
        if status is not None:
            self.attrs["status"] = status
        self.attrs.update(attrs)
        self.tracer._record(self.name, "X", self.t0,
                            self.tracer._now() - self.t0,
                            self.trace_id, self.span_id,
                            self.parent_id, self.attrs)

    # -- context-manager form ------------------------------------------

    def __enter__(self):
        self._token = _CURRENT.set(self.ctx)
        return self

    def __exit__(self, etype, exc, tb):
        _CURRENT.reset(self._token)
        if etype is not None and "status" not in self.attrs:
            self.attrs["status"] = "error"
            self.attrs["error"] = f"{etype.__name__}: {exc}"
        self.end()
        return False


class _NoopSpan:
    """Shared do-nothing stand-in returned when the tracer is off:
    no allocation, no lock, usable everywhere a SpanHandle is."""

    __slots__ = ()
    ctx = None
    trace_id = None
    span_id = None

    def set(self, **kw):
        return self

    def event(self, name, **kw):
        return self

    def end(self, status=None, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Ring-buffered span recorder (module docstring).

    ``recording`` gates everything: False means every entry point
    returns the shared no-op immediately. The ring holds completed
    records as plain dicts already shaped like Chrome trace events
    (``ph`` "X" complete / "i" instant, ``ts``/``dur`` in
    microseconds against the tracer epoch, causal ids in ``args``).
    """

    def __init__(self, ring_size: int = 16384, recording: bool = False,
                 stream=None):
        self.recording = bool(recording)
        self.ring_size = max(16, int(ring_size))
        self._ring: list = []
        self._head = 0            # next slot once the ring is full
        self._lock = locks.make_lock("obs.tracer.ring")
        self._ids = 0
        self._traces = 0
        self.dropped = 0          # records overwritten by the ring
        self.epoch = time.monotonic()
        self._pid = os.getpid()
        # stream: a writable text file object, or a path to open in
        # append mode; each completed record is one flushed JSON
        # line. Its OWN lock: a slow stream (NFS, full pipe) must
        # serialize only other stream writers, never the ring
        # appends the admission/dispatch hot paths perform under
        # self._lock
        self._stream = None
        self._stream_lock = locks.make_lock("obs.tracer.stream")
        self._stream_path = None
        if stream is not None:
            if isinstance(stream, str):
                self._stream_path = stream
                d = os.path.dirname(os.path.abspath(stream))
                if d:
                    os.makedirs(d, exist_ok=True)
                self._stream = open(stream, "a", encoding="utf-8")
            else:
                self._stream = stream
            self.recording = True

    # -- clock / ids ---------------------------------------------------

    def _now(self) -> float:
        """Microseconds since the tracer epoch."""
        return (time.monotonic() - self.epoch) * 1e6

    def monotonic_us(self, t_monotonic: float) -> float:
        """Map a raw time.monotonic() stamp onto the tracer's axis
        (retroactive spans: serve queue-wait from admitted_at)."""
        return (t_monotonic - self.epoch) * 1e6

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def new_trace(self, label: str = "t") -> str:
        """Fresh trace id (a serve request at admission, a device
        fit, a dispatch with no enclosing context)."""
        with self._lock:
            self._traces += 1
            return f"{label}{self._traces}"

    # -- span API ------------------------------------------------------

    def open_span(self, name: str, parent=None, trace: Optional[str] = None,
                  **attrs) -> SpanHandle:
        """Open a span WITHOUT entering its context (held across
        threads/callbacks; ``end()`` records it). ``parent`` defaults
        to the current context; an explicit ``trace=`` forces a ROOT
        span of that trace (the serve admission root, a fresh fit)
        regardless of ambient context."""
        if not self.recording:
            return NOOP_SPAN
        if parent is None and trace is None:
            parent = _CURRENT.get()
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = trace or self.new_trace(), None
        return SpanHandle(self, name, trace_id, self._next_id(),
                          parent_id, self._now(), attrs)

    def span(self, name: str, parent=None, trace=None, **attrs):
        """Context-managed span: enters the context (children parent
        automatically) and records on exit."""
        if not self.recording:
            return NOOP_SPAN
        return self.open_span(name, parent=parent, trace=trace,
                              **attrs)

    def record_event(self, name: str, trace_id=None, parent_id=None,
                     **attrs):
        """Instant event. With no explicit parent it attaches under
        the current context (or a fresh root trace)."""
        if not self.recording:
            return
        if trace_id is None:
            ctx = _CURRENT.get()
            if ctx is not None:
                trace_id, parent_id = ctx
            else:
                trace_id = self.new_trace()
        self._record(name, "i", self._now(), None, trace_id,
                     self._next_id(), parent_id, attrs)

    def record_span(self, name: str, t0_us: float, t1_us: float,
                    parent=None, trace=None, **attrs):
        """Retroactive complete span from two timestamps already on
        the tracer axis (``monotonic_us``) — how queue-wait spans are
        recorded at dispatch time from the admission stamp."""
        if not self.recording:
            return
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = trace or self.new_trace(), None
        self._record(name, "X", t0_us, max(0.0, t1_us - t0_us),
                     trace_id, self._next_id(), parent_id, attrs)

    # -- ring + stream -------------------------------------------------

    def _record(self, name, ph, ts, dur, trace_id, span_id,
                parent_id, attrs):
        rec = {"name": name, "ph": ph, "ts": round(ts, 1),
               "pid": self._pid,
               "tid": threading.get_ident() & 0x7FFFFFFF,
               "args": dict(attrs, trace=trace_id, span=span_id)}
        if parent_id is not None:
            rec["args"]["parent"] = parent_id
        if ph == "X":
            rec["dur"] = round(dur, 1)
        if ph == "i":
            rec["s"] = "t"  # instant scope: thread
        with self._lock:
            if len(self._ring) < self.ring_size:
                self._ring.append(rec)
            else:
                self._ring[self._head] = rec
                self._head = (self._head + 1) % self.ring_size
                self.dropped += 1
            stream = self._stream
        if stream is not None:
            try:
                # default=str: an instrumentation site passing a
                # non-JSON attr (a numpy scalar, a rid object) must
                # degrade to its string form, never raise out of the
                # dispatch/serve path it was merely tracing
                line = json.dumps(rec, default=str)
                with self._stream_lock:
                    stream.write(line + "\n")
                    stream.flush()
            except (OSError, ValueError, TypeError):
                pass  # a dead stream must never fail a dispatch

    def records(self) -> list:
        """Ring contents, oldest first (a copy)."""
        with self._lock:
            return self._ring[self._head:] + self._ring[:self._head]

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring = []
            self._head = 0
            self.dropped = 0

    def close(self):
        if self._stream is not None and self._stream_path is not None:
            try:
                self._stream.close()
            except OSError:
                pass
            self._stream = None

    # -- export --------------------------------------------------------

    def export(self, path: str) -> int:
        """Write the ring as Chrome trace-event JSON (the
        {"traceEvents": [...]} wrapper Perfetto / chrome://tracing
        parse). Returns the number of events written. Atomic
        (tmp + rename) so a reader never sees a torn file."""
        events = sorted(self.records(), key=lambda r: r["ts"])
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"tracer": "pint_tpu_torch.obs",
                             "dropped": self.dropped}}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            # default=str: one non-JSON attr must not kill the whole
            # export (same contract as the stream writer above)
            json.dump(doc, fh, default=str)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return len(events)

    def status(self) -> dict:
        with self._lock:
            n = len(self._ring)
        return {"recording": self.recording, "events": n,
                "dropped": self.dropped,
                "ring_size": self.ring_size,
                "spans_started": self._ids,
                "stream": self._stream_path}
