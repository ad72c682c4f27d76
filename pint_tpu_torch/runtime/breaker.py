"""Per-device circuit breaker for the dispatch supervisor (a copy of
pint_tpu/runtime/breaker.py with one more state).

The classic CLOSED -> OPEN -> HALF_OPEN breaker of a service mesh:

- CLOSED: dispatches flow; consecutive infra failures count up and
  trip the breaker at ``threshold``.
- OPEN: dispatches short-circuit to the host fallback without
  touching the device at all (a wedged device hangs on contact, so
  "try it and see" is exactly the wrong probe). After ``cooldown_s``
  the next dispatch attempt runs the BOUNDED probe.
- HALF_OPEN: the probe answered, one trial dispatch is allowed
  through; success closes the breaker, failure re-opens it with an
  escalated (doubled, capped) cooldown.
- LOST (the port's own): a sticky CUDA error (illegal address,
  device-side assert, launch failure, illegal instruction, ECC) has
  destroyed this process's CUDA context. Nothing in the process can
  use the card again, so the breaker is latched open for the life of
  the process: it never probes (a probe runs in a fresh process,
  which would succeed and then send the next dispatch into the dead
  context here) and only ``reset`` clears it.

The probe is injected by the supervisor (a subprocess that touches
the card, bounded by a kill timer), so this module stays stdlib only.

Thread safety: all transitions run under one lock; the probe itself
runs outside it (it can take tens of seconds) with a guard so only
one thread probes at a time.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from pint_tpu_torch.runtime import locks

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN", "LOST"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
LOST = "lost"

# cooldown escalation cap: a device that stays dead is re-probed at
# most every 8 minutes
_MAX_COOLDOWN_S = 480.0


class CircuitBreaker:
    """One backend's health gate. ``allow()`` -> "proceed" | "probe" |
    "reject"; every attempt reports back through ``on_result``."""

    def __init__(self, backend: str, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 probe: Optional[Callable[[], bool]] = None):
        from pint_tpu_torch import config

        self.backend = backend
        self.threshold = (config.breaker_threshold()
                          if threshold is None else int(threshold))
        self.base_cooldown_s = (config.breaker_cooldown_s()
                                if cooldown_s is None
                                else float(cooldown_s))
        self.cooldown_s = self.base_cooldown_s
        self.probe = probe or (lambda: True)
        self.state = CLOSED
        self.failures = 0          # consecutive, CLOSED state
        self.trips = 0             # lifetime OPEN transitions
        self.opened_at: Optional[float] = None
        self._lock = locks.make_lock("breaker.state")
        self._probing = locks.make_lock("breaker.probe")

    # -- gate ----------------------------------------------------------

    def allow(self) -> str:
        """Gate one dispatch attempt. "proceed": breaker closed;
        "probe": half-open trial (caller MUST report on_result);
        "reject": short-circuit to the fallback path."""
        with self._lock:
            if self.state == CLOSED:
                return "proceed"
            if self.state == LOST:
                return "reject"
            if self.state == HALF_OPEN:
                # one trial in flight already — everyone else degrades
                return "reject"
            if time.monotonic() - self.opened_at < self.cooldown_s:
                return "reject"
        # cooldown elapsed: bounded probe, outside the state lock
        # (it can take tens of seconds); only one prober at a time
        if not self._probing.acquire(blocking=False):
            return "reject"
        try:
            ok = bool(self.probe())
        except Exception:
            ok = False
        finally:
            self._probing.release()
        with self._lock:
            if self.state != OPEN:
                # someone else transitioned while we probed
                return "proceed" if self.state == CLOSED else "reject"
            if ok:
                self.state = HALF_OPEN
                return "probe"
            # still dead: re-arm with escalated cooldown
            self.opened_at = time.monotonic()
            self.cooldown_s = min(self.cooldown_s * 2, _MAX_COOLDOWN_S)
            return "reject"

    # -- outcome reporting ---------------------------------------------

    def on_result(self, success: bool):
        with self._lock:
            if self.state == LOST:
                # the context is gone: no verdict can revive it (a
                # dispatch that raced the latch proves nothing)
                return
            if success:
                self.state = CLOSED
                self.failures = 0
                self.cooldown_s = self.base_cooldown_s
                self.opened_at = None
                return
            if self.state == HALF_OPEN:
                # trial failed: straight back to OPEN, escalated
                self._trip(escalate=True)
                return
            self.failures += 1
            if self.failures >= self.threshold:
                self._trip(escalate=False)

    def abort_trial(self):
        """The half-open trial ended WITHOUT a backend-health verdict
        (the dispatched callable raised a caller bug before the
        backend mattered): return to OPEN with the cooldown
        unchanged, so the next window re-probes — never leave the
        breaker dangling in HALF_OPEN, which rejects everything."""
        with self._lock:
            if self.state == HALF_OPEN:
                self.state = OPEN
                self.opened_at = time.monotonic()

    def latch(self):
        """The device's CUDA context is lost (a sticky error): latch
        the breaker open for the life of the process. Counts as a
        trip when the breaker was not already open."""
        with self._lock:
            if self.state in (CLOSED, HALF_OPEN):
                self.trips += 1
            self.state = LOST
            self.opened_at = time.monotonic()
            self.failures = 0

    @property
    def is_lost(self) -> bool:
        with self._lock:
            return self.state == LOST

    def _trip(self, escalate: bool):
        self.state = OPEN
        self.trips += 1
        self.opened_at = time.monotonic()
        if escalate:
            self.cooldown_s = min(self.cooldown_s * 2, _MAX_COOLDOWN_S)
        self.failures = 0

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self.state != CLOSED

    def reset(self):
        with self._lock:
            self.state = CLOSED
            self.failures = 0
            self.cooldown_s = self.base_cooldown_s
            self.opened_at = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"backend": self.backend, "state": self.state,
                    "failures": self.failures, "trips": self.trips,
                    "cooldown_s": round(self.cooldown_s, 3)}
