"""Traced locks + the process lock-order graph (a copy of
pint_tpu/runtime/locks.py).

The serve/dispatch stack is ~40 hand-audited ``threading`` lock
sites whose discipline ("MetricsServer never takes an engine lock",
"no dispatch under the engine lock", journal fsync outside the cv)
was, before this module, asserted by one test each. This module is
the DYNAMIC half of the concurrency plane (the reference's linter
rule G16 is the static half): every lock in the dispatch/serve/obs layers is now
constructed through the factories below, so one env knob turns the
whole process into a ThreadSanitizer-style checked build.

- ``make_lock(name)`` / ``make_rlock(name)`` / ``make_condition``:
  disarmed ($PINT_TPU_LOCK_TRACE unset — the production default)
  they return the BARE stdlib primitives, a true zero-cost
  passthrough (banded <1% on the north-star step in bench's ``obs``
  block). Armed, they return ``TracedLock``/``TracedRLock`` wrappers
  that record per-thread acquisition ORDER into a process-global
  lock-order graph keyed by lock NAME (discipline is a property of
  the lock class, not the instance — two engines' ``serve.engine``
  locks are one node).
- **cycle detection**: adding edge A->B while B already reaches A in
  the graph is an inversion that can deadlock; it fires ONE
  ``lockorder:<A->B>`` incident per edge per episode — registry
  counter, ``obs.event``, rate-limited flight dump — the exact
  ``numerics:<reason>`` pattern of obs/health.py.
- **dispatch-under-engine-lock**: locks constructed with
  ``engine=True`` (the serve scheduler's cv/dispatch locks) register
  in the per-thread held set; ``DispatchSupervisor`` asks
  ``check_dispatch_clear()`` before a guarded dispatch, and a held
  engine lock fires ONE ``lockheld:<name>`` incident per lock name
  per episode (blocking-under-lock is the classic tail-latency bug
  G16 part 3 bans statically).
- **hold/contention accounting**: per-name ``pint_tpu_lock_wait_
  seconds`` / ``pint_tpu_lock_hold_seconds`` histograms ride the
  obs.metrics registry.
- ``reset()`` drops the graph, the per-edge incident latches and the
  arming cache (wired into ``obs.reset()`` — the test-isolation
  contract of every other obs plane).

Pure stdlib at import time (the runtime package property — obs
modules construct their locks through here without pulling torch);
config/obs/metrics are imported lazily, and only on ARMED paths.
``TracedRLock`` implements the private ``Condition`` protocol
(``_is_owned``/``_release_save``/``_acquire_restore``) so the serve
scheduler's ``Condition(engine_lock)`` works traced.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["TracedLock", "TracedRLock", "make_lock", "make_rlock",
           "make_plane_lock", "make_condition", "check_dispatch_clear",
           "configure", "reset", "status", "lock_graph_edges",
           "held_locks"]

# the plane's own guard — the one lock that cannot be traced
# without infinite recursion
_STATE_LOCK = threading.Lock()  # graftlint: allow G16 -- the lock-order graph's own guard cannot be a traced lock (tracing it would recurse into the graph it protects)

_ARMED: Optional[bool] = None

# lock-order graph: name -> set of names acquired while holding it
_EDGES: dict = {}
# per-edge / per-lock-name incident latches: exactly one labeled
# incident per episode (reset() ends the episode), with the flight
# recorder's per-reason min_interval as the second rate-limit layer
_FIRED_EDGES: set = set()
_FIRED_HELD: set = set()

_TLS = threading.local()


def _armed() -> bool:
    global _ARMED
    if _ARMED is None:
        from pint_tpu_torch import config

        _ARMED = config.lock_trace_enabled()
    return _ARMED


def configure(enabled: Optional[bool] = None):
    """Explicit arming override (tests, bench's off/on legs); None
    drops back to the $PINT_TPU_LOCK_TRACE env default. Only affects
    locks constructed AFTER the call — the obs.reset() contract
    (consumers built before keep their old primitives)."""
    global _ARMED
    with _STATE_LOCK:
        _ARMED = None if enabled is None else bool(enabled)


def reset():
    """Drop the graph, the incident latches and the arming cache
    (the ``obs.reset()`` isolation contract). Existing TracedLocks
    keep working — they just start painting a fresh graph."""
    global _ARMED
    with _STATE_LOCK:
        _ARMED = None
        _EDGES.clear()
        _FIRED_EDGES.clear()
        _FIRED_HELD.clear()


def _held_list() -> list:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def held_locks() -> list:
    """Names of the traced locks the CURRENT thread holds, in
    acquisition order (diagnostics + the dispatch-clear check)."""
    return [e[0].name for e in _held_list()]


def lock_graph_edges() -> dict:
    """Snapshot of the lock-order graph ({name: sorted successors})."""
    with _STATE_LOCK:
        return {a: sorted(bs) for a, bs in _EDGES.items()}


def status() -> dict:
    with _STATE_LOCK:
        return {"armed": bool(_ARMED),
                "edges": sum(len(b) for b in _EDGES.values()),
                "nodes": len(_EDGES),
                "cycles_fired": len(_FIRED_EDGES),
                "held_fired": len(_FIRED_HELD)}


def _reaches(src: str, dst: str) -> bool:
    """BFS over _EDGES — caller holds _STATE_LOCK."""
    seen = {src}
    todo = [src]
    while todo:
        cur = todo.pop()
        if cur == dst:
            return True
        for nxt in _EDGES.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return False


def _incident(reason: str, **extra):
    """One labeled concurrency incident: registry counter,
    ``obs.event``, rate-limited flight dump, warning log — the
    ``numerics:<reason>`` pattern (obs/health.py's _incident)."""
    _TLS.in_plane = True  # the counter/event/dump path takes plane locks
    try:
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import metrics as om

        om.counter(
            "pint_tpu_lock_incidents_total",
            "lock-order cycles + dispatch-under-engine-lock "
            "detections (runtime.locks)").inc(
            reason=reason.split(":", 1)[0])
        obs.event("locks.incident", reason=reason, **extra)
        obs.flight_dump(reason, **extra)
    except Exception:
        pass
    try:
        from pint_tpu_torch.logging import log

        log.warning("lock-sanitizer incident %s: %r", reason, extra)
    except Exception:
        pass
    finally:
        _TLS.in_plane = False


def _note_acquire(lock, waited_s: float):
    if getattr(_TLS, "in_plane", False):
        # plane-internal: the registry/histogram/flight locks the
        # recording below acquires must not re-enter the bookkeeping
        # (a non-reentrant row lock would deadlock on its own
        # hold-time record)
        return
    held = _held_list()
    for e in held:
        if e[0] is lock:
            e[1] += 1          # reentrant re-acquire: no new edge
            return
    name = lock.name
    new_cycle = None
    with _STATE_LOCK:
        for e in held:
            a = e[0].name
            if a == name:
                continue       # sibling instance of the same class
            succ = _EDGES.setdefault(a, set())
            if name not in succ:
                # adding a->name closes a cycle iff name already
                # reaches a through the painted graph
                if _reaches(name, a):
                    edge = f"{a}->{name}"
                    if edge not in _FIRED_EDGES:
                        _FIRED_EDGES.add(edge)
                        new_cycle = edge
                succ.add(name)
    if new_cycle is not None:
        _incident(f"lockorder:{new_cycle}", edge=new_cycle,
                  thread=threading.current_thread().name,
                  held=[e[0].name for e in held])
    held.append([lock, 1, time.perf_counter()])
    if waited_s > 0.0:
        _TLS.in_plane = True
        try:
            from pint_tpu_torch.obs import metrics as om

            om.histogram(
                "pint_tpu_lock_wait_seconds",
                "contention wait per traced-lock class").observe(
                waited_s, lock=name)
        except Exception:
            pass
        finally:
            _TLS.in_plane = False


def _note_release(lock, full: bool = False):
    if getattr(_TLS, "in_plane", False):
        return
    held = _held_list()
    for i in range(len(held) - 1, -1, -1):
        e = held[i]
        if e[0] is lock:
            e[1] = 0 if full else e[1] - 1
            if e[1] <= 0:
                del held[i]
                _TLS.in_plane = True
                try:
                    from pint_tpu_torch.obs import metrics as om

                    om.histogram(
                        "pint_tpu_lock_hold_seconds",
                        "hold time per traced-lock class").observe(
                        time.perf_counter() - e[2], lock=lock.name)
                except Exception:
                    pass
                finally:
                    _TLS.in_plane = False
            return


def check_dispatch_clear(what: str = "dispatch") -> bool:
    """Called by the supervisor at the guarded-dispatch boundary: a
    held ENGINE lock on the dispatching thread means a scheduler is
    blocking on device work (the G16 part-3 bug, caught live). Fires
    one ``lockheld:<name>`` incident per lock name per episode;
    returns True when clear. Free when no traced engine lock is held
    — the disarmed build never constructs one."""
    held = _held_list()
    bad = [e[0].name for e in held if getattr(e[0], "engine", False)]
    if not bad:
        return True
    for name in bad:
        with _STATE_LOCK:
            if name in _FIRED_HELD:
                continue
            _FIRED_HELD.add(name)
        _incident(f"lockheld:{name}", what=what, lock=name,
                  thread=threading.current_thread().name,
                  held=[e[0].name for e in held])
    return False


class _TracedBase:
    """Shared acquire/release bookkeeping over an inner stdlib
    primitive. ``name`` keys the order graph; ``engine=True`` marks
    a scheduler/engine lock for the dispatch-clear check."""

    def __init__(self, inner, name: str, engine: bool = False):
        self._inner = inner
        self.name = name
        self.engine = bool(engine)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self, time.perf_counter() - t0)
        return ok

    def release(self):
        # physical release FIRST: the hold-time record below touches
        # obs.metrics row locks, and when THIS lock is such a row's
        # lock (registry.render() iterating the lock histograms) a
        # note-then-release order re-acquires the still-held inner
        # primitive — self-deadlock. The held-list pop is thread-
        # local, so nothing observes the tiny reorder window.
        self._inner.release()
        _note_release(self)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"<{type(self).__name__} {self.name!r} "
                f"engine={self.engine}>")


class TracedLock(_TracedBase):
    def __init__(self, name: str, engine: bool = False):
        super().__init__(threading.Lock(), name, engine)  # graftlint: allow G16 -- the traced wrapper's own inner primitive; every consumer reaches it through make_lock

    def locked(self) -> bool:
        return self._inner.locked()


class TracedRLock(_TracedBase):
    """Reentrant traced lock implementing the private stdlib
    ``Condition`` protocol, so ``threading.Condition(TracedRLock)``
    works: ``wait()`` fully releases through ``_release_save`` (we
    drop the held entry and its hold time) and re-registers through
    ``_acquire_restore``."""

    def __init__(self, name: str, engine: bool = False):
        super().__init__(threading.RLock(), name, engine)  # graftlint: allow G16 -- the traced wrapper's own inner primitive; every consumer reaches it through make_rlock

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        st = self._inner._release_save()  # release-then-note, as release()
        _note_release(self, full=True)
        return st

    def _acquire_restore(self, state):
        t0 = time.perf_counter()
        self._inner._acquire_restore(state)
        _note_acquire(self, time.perf_counter() - t0)


def make_lock(name: str, engine: bool = False):
    """A mutex for the dispatch/serve/obs layers: bare
    ``threading.Lock`` disarmed, ``TracedLock`` armed. New lock
    checklist: construct through here, never a raw threading
    primitive."""
    if not _armed():
        return threading.Lock()  # graftlint: allow G16 -- the disarmed factory IS the sanctioned passthrough (zero-overhead production default)
    return TracedLock(name, engine=engine)


def make_plane_lock(name: str):
    """A BARE mutex for the obs RECORDING plane's own leaf rows
    (metric/histogram rows, the registry): the sanitizer records
    hold/wait histograms THROUGH those locks on every traced
    acquire/release, so tracing them is self-referential — e.g.
    ``render()`` acquiring the wait-histogram row's lock would
    trigger a wait-record into that same row and physically
    re-acquire the held, non-reentrant primitive (the _STATE_LOCK
    rationale, one layer up). Construction still flows through this
    module so the G16 raw-primitive check sees it declared; ``name``
    is kept for greppability/symmetry with make_lock."""
    del name
    return threading.Lock()  # graftlint: allow G16 -- the recording plane's own leaf locks must stay bare: the sanitizer records through them (self-reference deadlock if traced)


def make_rlock(name: str, engine: bool = False):
    """Reentrant sibling of ``make_lock``."""
    if not _armed():
        return threading.RLock()  # graftlint: allow G16 -- the disarmed factory IS the sanctioned passthrough (zero-overhead production default)
    return TracedRLock(name, engine=engine)


def make_condition(lock):
    """``threading.Condition`` over a factory-made lock (traced or
    bare — TracedRLock implements the Condition protocol)."""
    return threading.Condition(lock)  # graftlint: allow G16 -- the factory itself; Condition wraps the already-traced (or sanctioned-bare) lock
