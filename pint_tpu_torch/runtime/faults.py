"""Deterministic fault injection at the dispatch boundary (a copy of
pint_tpu/runtime/faults.py: the same KINDS and the same matching, so
one fault plan reads the same in both packages).

A device's failure modes — silent hangs, transient errors, NaN
garbage from a dying device, a drifting dispatch round trip — cannot
be reproduced on demand, so every supervisor behavior they trigger
(watchdog timeout, retry, breaker trip, host failover, K re-pick)
would otherwise be untestable on the CPU. This module injects exactly
those faults, deterministically, at the single choke point every
device call goes through (``DispatchSupervisor.dispatch``).

A plan is a list of rules matched by dispatch-key substring with
per-rule call counters (``after``/``count``), so a test can say "the
2nd and 3rd dispatches hang" and get exactly that, every run. No
randomness anywhere.

Usage::

    plan = FaultPlan([Fault(match="gls.fit", kind="hang",
                            seconds=5.0)])
    with plan.active():
        ...  # every matching dispatch now sleeps past its deadline

While ANY plan is active the supervisor always takes the guarded
worker path (even on the CPU device, where real hangs cannot happen)
so deadline behavior is exercised by the test suite.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional

from pint_tpu_torch.runtime import locks

__all__ = ["Fault", "FaultPlan", "active_plan", "TransientFault",
           "FatalFault"]

KINDS = ("hang", "error", "nan", "rtt_drift",
         # serving-lifecycle kinds, consumed by the serve
         # layer rather than the dispatch supervisor: "overload"
         # makes the admission controller treat capacity as
         # exhausted for matching submits (forces the shed-policy
         # path without needing a real million-user burst),
         # "tenant_burst" drains the matching tenant's token bucket
         # (a quota-exceeding tenant on demand), and "kill_restart"
         # kills the engine at the drain boundary mid-burst — a
         # simulated SIGKILL: in-flight futures die with the engine,
         # journal entries stay unacknowledged, and the restart path
         # (AOT restore + journal replay) is what recovers them.
         "overload", "tenant_burst", "kill_restart",
         # fleet kinds, consumed by serve.fleet:
         # "worker_kill" kills one named fleet worker mid-burst (its
         # engine dies like kill_restart, its lease stops beating,
         # and the front's expiry sweep re-homes its unacked journal
         # entries onto survivors), "lease_expire" forces one
         # worker's lease to read as expired at the front's next
         # sweep without killing the engine (a live worker whose
         # heartbeats stopped reaching the journal — the split-brain
         # case the ownership transfer must stay safe under).
         "worker_kill", "lease_expire")


class TransientFault(RuntimeError):
    """Injected error the classifier must treat as transient (the
    retry-with-backoff class: connection resets, UNAVAILABLE)."""


class FatalFault(ValueError):
    """Injected error the classifier must treat as fatal (the
    programming-error class: re-raise, no retry, no breaker trip)."""


@dataclass
class Fault:
    """One injection rule.

    match      substring of the dispatch key ("" matches every key)
    kind       "hang" | "error" | "nan" | "rtt_drift" — dispatch
               kinds, consumed by DispatchSupervisor.dispatch — or
               "overload" | "tenant_burst" | "kill_restart" —
               serving-lifecycle kinds, consumed by the serve
               admission controller / scheduler (see KINDS above)
    after      skip this many matching dispatches first
    count      apply to at most this many dispatches (None: forever)
    seconds    hang duration (must exceed the configured deadline to
               simulate a wedge; the guarded worker is abandoned and
               never runs the payload — it sleeps out the duration
               and raises internally, so the daemon thread lingers
               only for ``seconds``, doing no late device work)
    factor     rtt_drift: reported wall = factor x measured wall
    exc        error: exception INSTANCE to raise (default: a
               TransientFault)
    """

    match: str = ""
    kind: str = "hang"
    after: int = 0
    count: Optional[int] = None
    seconds: float = 5.0
    factor: float = 3.0
    exc: Optional[BaseException] = None
    seen: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")

    def applies(self, key: str) -> bool:
        """Match + advance this rule's deterministic counter."""
        if self.match not in key:
            return False
        n = self.seen
        self.seen += 1
        if n < self.after:
            return False
        if self.count is not None and n >= self.after + self.count:
            return False
        return True


class FaultPlan:
    """An activatable set of rules + the injection log.

    ``probe_ok`` overrides the breaker's bounded backend probe while
    the plan is active: False = "tunnel still dead" (half-open never
    opens), True = "tunnel revived" (half-open trial allowed), None =
    use the real probe. Tests flip it mid-plan to script a recovery.
    """

    def __init__(self, rules: Optional[List[Fault]] = None,
                 probe_ok: Optional[bool] = None):
        self.rules: List[Fault] = list(rules or [])
        self.probe_ok = probe_ok
        self.applied: List[tuple] = []   # (key, kind) log for asserts
        self._lock = locks.make_lock("faults.plan")

    def faults_for(self, key: str,
                   kinds: Optional[tuple] = None) -> List[Fault]:
        """The rules firing on this dispatch (counters advanced).

        ``kinds`` scopes the lookup: only rules of those kinds are
        tested (and have their deterministic counters advanced).
        The dispatch supervisor and the serve admission/drain layers
        consume DIFFERENT kinds at DIFFERENT choke points — without
        the scope, an admission check would advance a hang rule's
        ``after`` counter and silently shift which dispatch it fires
        on."""
        with self._lock:
            rules = self.rules if kinds is None else \
                [f for f in self.rules if f.kind in kinds]
            hits = [f for f in rules if f.applies(key)]
            for f in hits:
                self.applied.append((key, f.kind))
            return hits

    def clear(self):
        """Deactivate every rule in place (scripted 'recovery')."""
        with self._lock:
            self.rules.clear()

    @contextlib.contextmanager
    def active(self):
        """Install this plan process-wide for the with-block."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE
