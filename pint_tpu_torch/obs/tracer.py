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
  before allocating anything — the fault-free hot path pays one call
  of ``Tracer.active`` (two attribute reads) and a branch per
  instrumentation point;
- **profiler sessions**: while a ``torch.profiler`` session is open
  anywhere in the process (torch's process-wide flag; the one test is
  ``Tracer.active``) the tracer records as if it were on, so a
  profiled window brings the program's spans with it. On a thread the
  profiler records (its thread-local flag), a context-managed span
  also enters ``torch.profiler.record_function`` under its own name
  for its whole life: it is a host range, and a device-side
  annotation, of the profiler's trace. Held spans (``open_span``,
  ended explicitly, perhaps on another thread) stay in the ring only.

Timestamps (``ts``) are microseconds of the real-time clock since the
Unix epoch: the axis ``torch.profiler`` (Kineto) stamps its host
events on, so a ring span lies on a profiled window's trace.
Durations come from ``time.perf_counter()``, and ``ts`` is the span's
perf-counter start mapped onto the real-time axis when it is recorded.
``perf_us`` and ``monotonic_us`` map stamps of the two monotonic
clocks onto the axis for retroactive spans (the supervisor's worker
phases, the serve layer's queue-wait from ``admitted_at``).
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import threading

from pint_tpu_torch.runtime import locks
import time
from typing import Optional

__all__ = ["Tracer", "SpanHandle", "current", "attach", "CLOCK"]

# what ``ts`` counts, stated in every export
CLOCK = "realtime_us"


def _thread_profiled() -> bool:
    """True where the open profiler session records this thread's ops
    (torch's thread-local flag: a thread started inside a session is
    not recorded unless the session profiles every thread)."""
    return sys.modules["torch"]._C._autograd._profiler_enabled()

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
                 "parent_id", "t0", "attrs", "_ended", "_token", "_rf")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 t0, attrs):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0              # time.perf_counter() at the start
        self.attrs = attrs
        self._ended = False
        self._token = None
        self._rf = None           # the profiler range, while entered

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

    def end(self, status: Optional[str] = None, at: Optional[float] = None,
            **attrs):
        """Record the span; ``at`` is its end as a ``time.perf_counter()``
        stamp already taken (now when None)."""
        if self._ended:
            return
        self._ended = True
        t1 = time.perf_counter() if at is None else at
        if status is not None:
            self.attrs["status"] = status
        self.attrs.update(attrs)
        self.tracer._record(self.name, "X", self.tracer.perf_us(self.t0),
                            (t1 - self.t0) * 1e6, self.trace_id,
                            self.span_id, self.parent_id, self.attrs)

    # -- context-manager form ------------------------------------------

    def __enter__(self):
        self._token = _CURRENT.set(self.ctx)
        prof = self.tracer.torch_profiler
        if prof._is_profiler_enabled and _thread_profiled():
            self._rf = prof.record_function(self.name)
            self._rf.__enter__()
            # the ring's start at the range's, on the profiler's axis
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, etype, exc, tb):
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(None, None, None)
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

    ``recording`` gates everything, with an open profiler session:
    neither means every entry point returns the shared no-op
    immediately. The ring holds completed records as plain dicts
    already shaped like Chrome trace events (``ph`` "X" complete / "i"
    instant, ``ts`` in real-time microseconds, ``dur`` in
    microseconds, causal ids in ``args``).
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
        self._pid = os.getpid()
        # its ``_is_profiler_enabled``: one attribute read per span
        from torch.autograd import profiler as torch_profiler

        self.torch_profiler = torch_profiler
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
        """Now on the ring's axis: real-time microseconds."""
        return time.time_ns() / 1e3

    def perf_us(self, t_perf: float) -> float:
        """Map a raw time.perf_counter() stamp onto the ring's axis."""
        return t_perf * 1e6 + (time.time_ns() / 1e3
                               - time.perf_counter() * 1e6)

    def monotonic_us(self, t_monotonic: float) -> float:
        """Map a raw time.monotonic() stamp onto the ring's axis
        (retroactive spans: serve queue-wait from admitted_at)."""
        return t_monotonic * 1e6 + (time.time_ns() / 1e3
                                    - time.monotonic() * 1e6)

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

    def active(self) -> bool:
        """True while spans are recorded: the tracer is on, or a
        ``torch.profiler`` session is open anywhere in the process
        (torch.autograd.profiler's module-level flag, set by every
        session's start and cleared by its stop, whatever thread runs
        them). Every entry point, here and in ``obs``, asks this."""
        return self.recording or self.torch_profiler._is_profiler_enabled

    def open_span(self, name: str, parent=None, trace: Optional[str] = None,
                  at: Optional[float] = None, **attrs) -> SpanHandle:
        """Open a span WITHOUT entering its context (held across
        threads/callbacks; ``end()`` records it). ``parent`` defaults
        to the current context; an explicit ``trace=`` forces a ROOT
        span of that trace (the serve admission root, a fresh fit)
        regardless of ambient context. ``at``: the start as a
        ``time.perf_counter()`` stamp already taken (now when None)."""
        if not self.active():
            return NOOP_SPAN
        if parent is None and trace is None:
            parent = _CURRENT.get()
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = trace or self.new_trace(), None
        return SpanHandle(self, name, trace_id, self._next_id(),
                          parent_id,
                          time.perf_counter() if at is None else at, attrs)

    def span(self, name: str, parent=None, trace=None, **attrs):
        """Context-managed span: enters the context (children parent
        automatically) and records on exit."""
        if not self.active():
            return NOOP_SPAN
        return self.open_span(name, parent=parent, trace=trace,
                              **attrs)

    def record_event(self, name: str, trace_id=None, parent_id=None,
                     **attrs):
        """Instant event. With no explicit parent it attaches under
        the current context (or a fresh root trace)."""
        if not self.active():
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
        the ring's axis (``perf_us``, ``monotonic_us``) — how
        queue-wait spans are recorded at dispatch time from the
        admission stamp."""
        if not self.active():
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

    def export(self, path: str, base_us: float = 0.0) -> int:
        """Write the ring as Chrome trace-event JSON (the
        {"traceEvents": [...]} wrapper Perfetto / chrome://tracing
        parse). Returns the number of events written. Atomic
        (tmp + rename) so a reader never sees a torn file.

        ``ts`` is real-time microseconds since the Unix epoch less
        ``base_us``, as ``otherData`` states: given a profiler trace's
        ``baseTimeNanoseconds / 1000``, the events land on that
        ``trace.json``'s axis, and the two files' events merge."""
        events = sorted(self.records(), key=lambda r: r["ts"])
        if base_us:
            events = [dict(r, ts=round(r["ts"] - base_us, 3))
                      for r in events]
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"tracer": "pint_tpu_torch.obs",
                             "dropped": self.dropped, "clock": CLOCK,
                             "ts_base_us": base_us}}
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
