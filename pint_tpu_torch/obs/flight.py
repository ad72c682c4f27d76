"""Flight recorder: dump the tracer's recent-span ring on serving
incidents.

A post-mortem of a production incident needs two things: *what was
pending* (the request journal already records that, fsynced) and
*what the system was doing* (nowhere, before this module). The
flight recorder pairs with the journal: when an incident trigger
fires — breaker-open, shed-burst, shutdown drain, unhandled engine
exception — the bounded ring of the most recent spans/events is
dumped to a timestamped JSON file in ``$PINT_TPU_FLIGHT_DIR``
(``config.flight_dir``), together with the trigger reason and any
caller-supplied context (supervisor counters, admission sheds).

Design constraints, in order:

- **never in the way**: a dump failure is counted, logged and
  swallowed — the incident path (a failover mid-drain) must not grow
  a new failure mode from its own black box;
- **rate-limited per reason**: a breaker flapping open every
  cooldown, or a sustained shed storm, writes one dump per
  ``min_interval_s`` (default 10 s) per reason, not one per event;
- **bounded**: the payload is the ring (``config.trace_ring_size``
  completed records) — dump size is O(ring), never O(history).

Arming the recorder (setting the dir) turns on span RECORDING even
when $PINT_TPU_TRACE is off: an empty black box records nothing.
The dump file is Chrome-trace-compatible at the ``events`` key
(same record shape the tracer exports), so a post-mortem can load
it in Perfetto after extracting ``{"traceEvents": events}``.
"""

from __future__ import annotations

import json
import os
from pint_tpu_torch.runtime import locks
import time
from typing import Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """One directory's incident dumper (module docstring)."""

    def __init__(self, dirpath: str, tracer,
                 min_interval_s: float = 10.0):
        self.dir = dirpath
        self.tracer = tracer
        self.min_interval_s = float(min_interval_s)
        self._last_by_reason: dict = {}
        self._lock = locks.make_lock("obs.flight")
        self.dumps = 0
        self.suppressed = 0
        self.errors = 0
        self.last_path: Optional[str] = None
        self.last_reason: Optional[str] = None

    def dump(self, reason: str, **extra) -> Optional[str]:
        """Write one incident dump; returns its path, or None when
        rate-limited or failed. Thread-safe; never raises."""
        now = time.monotonic()
        with self._lock:
            last = self._last_by_reason.get(reason)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_by_reason[reason] = now
        try:
            os.makedirs(self.dir, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            fname = f"flight-{stamp}-{self.dumps:03d}-" \
                    f"{_slug(reason)}.json"
            path = os.path.join(self.dir, fname)
            doc = {
                "reason": reason,
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime()),
                "pid": os.getpid(),
                "tracer": self.tracer.status(),
                "extra": _jsonable(extra),
                # the black box: most recent completed spans/events,
                # oldest first, Chrome-record shaped
                "events": self.tracer.records(),
            }
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                # default=str: one non-JSON span attr in the ring
                # must not kill the incident dump
                json.dump(doc, fh, default=str)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except Exception as e:
            self.errors += 1
            try:
                from pint_tpu_torch.logging import log

                log.warning("flight-recorder dump (%s) failed: %r",
                            reason, e)
            except Exception:
                pass
            return None
        with self._lock:
            self.dumps += 1
            self.last_path = path
            self.last_reason = reason
        try:
            from pint_tpu_torch.logging import log

            log.warning("flight recorder dumped %d events to %s "
                        "(trigger: %s)", len(doc["events"]), path,
                        reason)
        except Exception:
            pass
        return path

    def status(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "dumps": self.dumps,
                    "suppressed": self.suppressed,
                    "errors": self.errors,
                    "last_reason": self.last_reason,
                    "last_path": self.last_path}


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in reason)[:48]


def _jsonable(obj):
    """Best-effort JSON coercion of caller-supplied context — a
    non-serializable extra must not kill the dump."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return repr(obj)
