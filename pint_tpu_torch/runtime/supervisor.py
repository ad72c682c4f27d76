"""Dispatch supervisor: watchdog deadlines, retry/breaker routing,
host failover, RTT-drift re-measurement (a port of
pint_tpu/runtime/supervisor.py).

Every device call of the port goes through ``DispatchSupervisor.
dispatch``, under the reference's dispatch keys, so a fault plan
written for one package hits the same call sites in the other. What
the supervisor does for each call:

- **watchdog deadline**: the dispatch runs on a guarded daemon
  worker; the caller waits at most a deadline, then gets
  ``DispatchTimeout`` instead of blocking forever
  ($PINT_TPU_DISPATCH_DEADLINE_MS overrides). The worker thread cannot
  be killed (a wedge is inside the CUDA runtime); it is abandoned and its
  eventual result discarded. The worker moves every CUDA tensor of the
  result to the host (``_host_read``), which synchronizes, so the
  deadline covers the device work, not only its enqueue.
- **classification + retry**: transient errors (connection resets,
  ``torch.cuda.OutOfMemoryError``, an injected ``TransientFault``)
  retry with jittered exponential backoff; anything else is a caller
  bug and re-raises untouched — a kernel that fails to build or has
  no image for the card is a caller bug too, and never fails over to
  its plain version.
- **sticky CUDA errors**: an illegal address, a device-side assert,
  an unspecified launch failure, an illegal instruction or an ECC
  error destroys the process's CUDA context. Such an error is classed
  apart: no retry, the device's breaker is latched LOST for the life
  of the process (``runtime.breaker``), and the dispatch fails over
  like a timeout (``DeviceLost``); every later dispatch on that device
  short-circuits without touching it.
- **circuit breaker**: repeated timeouts/transient failures trip the
  device's breaker OPEN, after which dispatches short-circuit to their
  host fallback. Half-open re-probes run in a subprocess under a kill
  timer (``bounded_backend_probe``).
- **host failover**: a dispatch given a ``fallback`` returns its
  result (counted, logged) whenever the device path is timed out,
  broken or breaker-open; without one the classified exception
  propagates so the call site can fail over at a higher level (the
  device fitter falls back to the whole host fitter). A fallback
  never reads from the card: it rebuilds its inputs on the CPU from
  host state.
- **RTT drift**: a guarded dispatch whose wall deviates >2x from the
  RTT-based prediction triggers a bounded re-measure and a re-pick of
  the power-of-two steps-per-dispatch K
  (``config.auto_steps_per_dispatch``). On a local card the measured
  RTT sits far below ``_DRIFT_FLOOR_MS``, so no verdict fires unless a
  plan injects ``rtt_drift``.
- **pipeline mode** (``dispatch_async``): issue the next chunk while
  the current one runs; each ``DispatchFuture`` delivers exactly what
  the synchronous dispatch would have, the deadline scaled by the
  in-flight depth at issue.

Torch has no process default device, so each call site passes the
device it dispatches to (``device=``; None means the CPU). Breakers
are keyed by device ("cuda:0", "cpu"). A dispatch runs guarded when
its device is CUDA or a fault plan is active, and inline otherwise;
``pinned`` marks a call the caller chose to run on the CPU device.

The deadline: the reference predicts 8 x RTT x steps x depth with a
1 s floor, a model of a 100-250 ms remote round trip. A local card
has no such round trip (a one-element op read with ``.item()`` costs
tens of microseconds), while a chain chunk or a streaming pass
legitimately runs for seconds. So on CUDA the floor is 300 s
(``_DEADLINE_FLOOR_CUDA_MS``): the watchdog catches wedges, which last
minutes or forever, and never polices a slow but live call. The first
call per key adds the compile allowance (``nvcc`` builds, ``torch.func``
start-up).

The worker thread does not inherit the caller's thread-local torch
state: grad mode and inference mode are captured at issue and
re-entered in the worker, and so is the caller's span context
(``obs.attach``), so spans opened in the payload parent under the
``dispatch/<key>`` span; the current CUDA stream is not carried (a
worker runs on the default stream). A ``torch.profiler`` session
records the worker's ops only where it profiles every thread, but the
worker's spans reach the ring in any session (``obs.tracer``). While
spans record, each dispatch gets the child ``dispatch.run`` (``fn`` up
to its return: host assembly and enqueue) and, when guarded,
``dispatch.read`` (the worker's host read), stamped by the same clock
reads as the wall decomposition below, so the self time of a guarded
``dispatch/<key>`` is the hand-off: worker start and wake, breaker,
deadline and bookkeeping.

The shadow oracle (``dispatch(shadow=)``): every Nth successful
device dispatch of a key that passes a ``shadow`` hook
($PINT_TPU_SHADOW_RATE) hands the result to ``obs.health``'s background
replay on the numpy mirror, which records the drift in sigma; failover
results and pinned calls are never shadowed. With ``obs.perf`` armed
($PINT_TPU_PERF) a guarded dispatch splits its wall into queue_wait
(worker start), host_assembly (``fn`` up to its return: the host work
and the enqueue), device_wall (the worker's host read and a
``torch.cuda.synchronize()``: the device work) and collect (worker wake
and unboxing), recorded in ``RuntimeMetrics.perf``. The first call per
key feeds the compile ledger (``obs.perf.note_compile``), and a breaker
tripping open fires one automatic profiler window
(``obs.perf.auto_window``, armed by $PINT_TPU_PROFILE_DIR).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from pint_tpu_torch.runtime import faults, locks
from pint_tpu_torch.runtime.breaker import CircuitBreaker

__all__ = ["DispatchSupervisor", "DispatchFuture", "RuntimeMetrics",
           "DispatchError", "DispatchTimeout", "BackendUnavailable",
           "DeviceLost", "RetriesExhausted", "get_supervisor", "breaker_for",
           "reset_runtime", "bounded_backend_probe", "backend_of"]

# deadline = margin x (rtt x steps), floored: generous by design — the
# watchdog exists to catch wedges (minutes/forever), not to police a
# slow-but-live dispatch into a spurious failover
_DEADLINE_MARGIN = 8.0
_DEADLINE_FLOOR_MS = 1000.0
# the floor on a CUDA device: a chain chunk of 256 steps or a
# streaming pass runs for seconds, a wedge for minutes or forever
_DEADLINE_FLOOR_CUDA_MS = 300_000.0
# RTT assumed when the first measurement on a device fails
_RTT_FALLBACK_MS = 250.0
# the fault kinds the SUPERVISOR consumes at the dispatch boundary —
# serving-lifecycle kinds are consumed by the serve layer at its own
# choke points and must not have their counters advanced here
_DISPATCH_FAULT_KINDS = ("hang", "error", "nan", "rtt_drift")

# drift window: observed wall within [1/2x, 2x] of prediction is fine
_DRIFT_FACTOR = 2.0
# predictions below this are noise on any device — no drift verdicts
_DRIFT_FLOOR_MS = 5.0

class DispatchError(RuntimeError):
    """Base class for supervised-dispatch infrastructure failures
    (never raised for caller bugs — those re-raise unclassified)."""


class DispatchTimeout(DispatchError, TimeoutError):
    """The watchdog deadline expired; the worker was abandoned."""


class BackendUnavailable(DispatchError):
    """The device's circuit breaker is open and the call site provided
    no host fallback."""


class RetriesExhausted(DispatchError):
    """Transient errors outlasted the retries (or tripped the breaker)
    and the call site gave no fallback. ``__cause__`` is the last one.
    (The reference re-raises the transient error itself, which its call
    sites, catching DispatchError, do not fail over from.)"""


class DeviceLost(DispatchError):
    """A sticky CUDA error destroyed this process's CUDA context; the
    device's breaker is latched and nothing may touch the card again.
    ``__cause__`` is the device's own error."""


def backend_of(device) -> str:
    """The breaker key of a device: "cpu", or "cuda:<index>" (an
    unindexed CUDA device is the current one). None is the CPU."""
    if device is None:
        return "cpu"
    dev = str(device)
    if dev == "cpu" or dev.startswith("cpu:"):
        return "cpu"
    if dev == "cuda":
        import torch

        idx = torch.cuda.current_device() \
            if torch.cuda.is_initialized() else 0
        return f"cuda:{idx}"
    return dev


class RuntimeMetrics:
    """Supervisor counters — the observability contract: a degraded run
    must be LABELED (snapshots embed ``snapshot()``), never silently
    slow.

    The counters are registry-backed: each instance holds bound
    children of the process-global ``obs.metrics`` registry
    (``pint_tpu_dispatch_<name>_total``, labelled by a per-instance
    ``scope``), and ``snapshot()``/attribute reads are derived views of
    the same values. The dispatch-wall HistogramSet shares its rows
    with the registry's ``pint_tpu_dispatch_wall_seconds`` histogram.
    ``device_lost`` (the port's own) counts sticky CUDA errors. The
    dispatch-wall decomposition rows (``perf``: per (pool, key) x
    queue_wait | host_assembly | device_wall | collect) are recorded
    only when the perf plane is armed, and share their rows with the
    ``pint_tpu_perf_dispatch_phase_seconds`` histogram."""

    _COUNTERS = ("dispatches", "guarded", "retries", "timeouts",
                 "transient_errors", "failovers",
                 "breaker_rejections", "breaker_recoveries",
                 "abandoned_workers", "rtt_remeasures",
                 "async_dispatches", "device_lost")

    def __init__(self):
        from pint_tpu_torch.obs import HistogramSet
        from pint_tpu_torch.obs import metrics as om

        self._lock = locks.make_lock("runtime.metrics")
        self.scope = om.new_scope("sup")
        self._c = {
            name: om.counter(
                f"pint_tpu_dispatch_{name}_total",
                f"supervisor {name.replace('_', ' ')}"
            ).child(scope=self.scope)
            for name in self._COUNTERS}
        self._g_inflight = om.gauge(
            "pint_tpu_dispatch_max_inflight",
            "peak pipelined in-flight depth").child(scope=self.scope)
        self._g_rtt = om.gauge(
            "pint_tpu_dispatch_last_rtt_ms",
            "last re-measured dispatch RTT").child(scope=self.scope)
        self._g_k = om.gauge(
            "pint_tpu_dispatch_last_k",
            "last re-picked steps-per-dispatch K"
        ).child(scope=self.scope)
        self.last_rtt_ms: Optional[float] = None
        self.last_k: Optional[int] = None
        self.max_inflight = 0   # peak pipelined depth observed
        # per-(pool, key) dispatch-wall histograms: log-bucketed, O(1)
        # memory, embedded as the `latency` block of snapshot() — rows
        # shared with the registry histogram
        hist = om.histogram("pint_tpu_dispatch_wall_seconds",
                            "supervised dispatch wall per "
                            "(pool, key)")
        scope = self.scope
        self.latency = HistogramSet(
            row_factory=lambda key, metric: hist.row(
                scope=scope, pool=str(key[0]), key=str(key[1]),
                metric=metric))
        phist = om.histogram("pint_tpu_perf_dispatch_phase_seconds",
                             "supervised dispatch wall "
                             "decomposition per (pool, key) x phase")
        self.perf = HistogramSet(
            row_factory=lambda key, metric: phist.row(
                scope=scope, pool=str(key[0]), key=str(key[1]),
                metric=metric))

    def __getattr__(self, name):
        # registry-backed counter reads (the `metrics.timeouts`
        # attribute surface)
        c = self.__dict__.get("_c")
        if c is not None and not name.startswith("_") and \
                name in type(self)._COUNTERS:
            return int(c[name].value())
        raise AttributeError(name)

    def bump(self, name: str, n: int = 1):
        self._c[name].inc(n)

    def note_inflight(self, depth: int):
        with self._lock:
            self.max_inflight = max(self.max_inflight, depth)
            self._g_inflight.set(self.max_inflight)

    def note_rtt(self, rtt_ms: float, k: int):
        """Record a drift re-measure outcome."""
        self.last_rtt_ms = rtt_ms
        self.last_k = k
        self._g_rtt.set(rtt_ms)
        self._g_k.set(k)

    def snapshot(self) -> dict:
        out = {name: int(self._c[name].value())
               for name in self._COUNTERS}
        with self._lock:
            out["max_inflight"] = self.max_inflight
        if self.last_rtt_ms is not None:
            out["last_rtt_ms"] = round(self.last_rtt_ms, 3)
        if self.last_k is not None:
            out["last_k"] = self.last_k
        out["breakers"] = {b: br.snapshot()
                           for b, br in dict(_BREAKERS).items()}
        lat = self.latency.snapshot()
        if lat:
            out["latency"] = lat
        pf = self.perf.snapshot()
        if pf:
            out["perf"] = pf
        return out


# ------------------------------------------------------------------
# per-device breaker registry (breakers are process-global: device
# health is a process fact, while supervisor COUNTERS can be per
# instance)
# ------------------------------------------------------------------

_BREAKERS: dict = {}
_BREAKERS_LOCK = locks.make_lock("runtime.breaker_table")

_PROBE_SRC = ("import torch; torch.ones(1, device={dev!r}).sum().item(); "
              "print('ok')")


def bounded_backend_probe(timeout_s: Optional[float] = None,
                          device: str = "cuda") -> bool:
    """Hang-proof device liveness probe: touch the card in a SUBPROCESS
    under a kill timer. Probing in-process is the bug, not the fix: a
    wedged device hangs the caller, and after a sticky error this
    process's context is gone while a fresh one would answer."""
    from pint_tpu_torch import config

    if timeout_s is None:
        timeout_s = config.breaker_probe_timeout_s()
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC.format(dev=device)],
            timeout=timeout_s, capture_output=True, env=dict(os.environ))  # graftlint: allow G17 -- whole-env passthrough to the hang-probe subprocess (forwards, never parses; the probe needs the caller's CUDA_VISIBLE_DEVICES and library paths)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def _probe_for(backend: str) -> Callable[[], bool]:
    def probe() -> bool:
        plan = faults.active_plan()
        if plan is not None and plan.probe_ok is not None:
            return bool(plan.probe_ok)
        if backend == "cpu":
            return True  # the local host cannot wedge like a device
        return bounded_backend_probe(device=backend)

    return probe


def breaker_for(backend: str) -> CircuitBreaker:
    with _BREAKERS_LOCK:
        if backend not in _BREAKERS:
            _BREAKERS[backend] = CircuitBreaker(
                backend, probe=_probe_for(backend))
        return _BREAKERS[backend]


# ------------------------------------------------------------------
# the supervisor
# ------------------------------------------------------------------


class DispatchSupervisor:
    """Routes device dispatches through deadline/retry/breaker/failover
    policy. One process-global instance serves the fitters
    (``get_supervisor``); a caller may own its own (self-contained
    counters, shared process-global breakers)."""

    def __init__(self, metrics: Optional[RuntimeMetrics] = None):
        self.metrics = metrics or RuntimeMetrics()
        self._seen: set = set()   # dispatch keys past first call
        self._inflight = 0        # async dispatches currently issued
        self._inflight_lock = locks.make_lock("runtime.inflight")

    # -- public API ----------------------------------------------------

    def dispatch(self, fn, *args, key: str = "dispatch",
                 steps: int = 1, kw: Optional[dict] = None,
                 fallback: Optional[Callable] = None,
                 guard: Optional[bool] = None, pinned: bool = False,
                 depth: int = 1, _plan_hits=None,
                 shadow: Optional[Callable] = None,
                 shadow_kind: Optional[str] = None,
                 info: Optional[dict] = None, device=None):
        """Run ``fn(*args, **kw)`` under supervision.

        key       stable label for this call site (deadline first-call
                  compile allowance + fault matching + logs)
        device    the torch device ``fn`` runs on (None: the CPU); it
                  picks the breaker and whether the call is guarded
        steps     iterations chained inside this one call (scales the
                  deadline prediction)
        fallback  zero-arg host-path callable; invoked (and counted as
                  a failover) on timeout / transient exhaustion /
                  breaker-open / a lost device. Without one the
                  DispatchError raises.
        guard     force (True) or suppress (False) the watchdog
                  worker. Default: guarded on CUDA and whenever a
                  fault plan is active; inline on the CPU.
        pinned    the caller chose to run this call on the CPU device
                  (config.solve_scope): treated as hang-free, so it
                  stays inline and neither consults nor feeds a
                  breaker.
        depth     in-flight pipeline depth at issue time (set by
                  dispatch_async): scales the watchdog deadline and
                  suppresses drift verdicts.
        info      optional caller-owned dict the supervisor marks
                  with ``{"failover": True}`` when this dispatch
                  resolved through its host fallback.
        shadow    shadow-oracle replay hook: ``shadow(out) -> drift
                  sigma | None`` re-runs the completed solve on the
                  numpy mirror. The supervisor only schedules it: when
                  $PINT_TPU_SHADOW_RATE says this key's Nth successful
                  dispatch is due, the hook runs on a background daemon
                  thread and the drift lands in ``obs.health`` — never
                  on the dispatch's own path, never on a failover
                  result or a pinned call (both ran on the host, so a
                  mirror replay would read as zero drift).
        shadow_kind  health-kind label of the shadow recording (the
                  dispatch key by default).
        _plan_hits  internal: fault-plan rules pre-fetched at issue
                  time by dispatch_async; first attempt only.

        Every dispatch runs under a tracer span ("dispatch/<key>")
        parented by the caller's context — retries, timeouts, breaker
        transitions, failovers and RTT re-measures are child events.
        With tracing off the span is the shared no-op (one branch).
        """
        from pint_tpu_torch import obs

        kw = kw or {}
        backend = backend_of(device)
        # lock sanitizer: a guarded dispatch issued while this thread
        # holds a traced ENGINE lock is blocking under a lock — one
        # labeled ``lockheld:<name>`` incident per episode
        locks.check_dispatch_clear(f"dispatch/{key}")
        with obs.span(f"dispatch/{key}", kind="dispatch",
                      backend=backend, steps=steps, depth=depth,
                      pinned=pinned) as sp:
            fo: dict = info if info is not None else {}
            out = self._dispatch_in_span(
                sp, fn, args, kw, key, steps, fallback, guard,
                pinned, depth, _plan_hits, backend, _fo=fo)
            if shadow is not None and not fo.get("failover") \
                    and not pinned:
                self._maybe_shadow(key, shadow_kind or key, shadow, out)
            return out

    def _maybe_shadow(self, key, kind, shadow, out):
        """Shadow-oracle scheduler: rate-gate per key, then hand the
        replay to the health monitor's background thread. Never raises
        into the dispatch path."""
        try:
            from pint_tpu_torch.obs import health as _health

            mon = _health.get_monitor()
            if not mon.shadow_rate or not mon.shadow_due(key):
                return
            from pint_tpu_torch import obs

            obs.event("health.shadow_issue", key=key, kind=kind)
            mon.shadow_replay(kind, key, lambda: shadow(out))
        except Exception:  # the black box must not break dispatch
            pass

    def _dispatch_in_span(self, sp, fn, args, kw, key, steps,
                          fallback, guard, pinned, depth, _plan_hits,
                          backend, _fo: Optional[dict] = None):
        from pint_tpu_torch import obs

        plan = faults.active_plan()
        if guard is None:
            # pinned calls stay inline even under a fault plan: they
            # run on the CPU, which cannot wedge (error/nan faults
            # still apply inline)
            guard = (backend != "cpu" or plan is not None) \
                and not pinned
        m = self.metrics
        m.bump("dispatches")
        # pinned dispatches carry no evidence about the device's
        # health: they neither consult nor feed its breaker
        br = None if pinned else breaker_for(backend)
        gate = "proceed" if br is None else br.allow()
        if gate == "reject":
            m.bump("breaker_rejections")
            sp.event("breaker.reject", backend=backend)
            return self._failover(fallback, key, BackendUnavailable(
                f"{backend} circuit breaker is open "
                f"(dispatch {key!r} short-circuited to host)"), sp,
                fo=_fo)
        probing = gate == "probe"

        from pint_tpu_torch import config

        retries = config.dispatch_retries()
        deadline_s = self._deadline_s(key, steps, backend,
                                      depth=depth)
        # perf decomposition arming: one cached-bool read when
        # disarmed; the phases exist only on the guarded worker, whose
        # fn-return and host-read boundaries ARE the split
        perf_on = False
        if guard:
            from pint_tpu_torch.obs import perf as _perf

            perf_on = _perf.enabled()
        attempt = 0
        while True:
            if _plan_hits is not None:
                hits, _plan_hits = _plan_hits, None
            else:
                hits = plan.faults_for(
                    key, kinds=_DISPATCH_FAULT_KINDS) \
                    if plan is not None else []
            pre_sleep = sum(f.seconds for f in hits
                            if f.kind == "hang")
            nan = any(f.kind == "nan" for f in hits)
            inj_err = next((f for f in hits if f.kind == "error"),
                           None)
            drift = 1.0
            for f in hits:
                if f.kind == "rtt_drift":
                    drift *= f.factor
            t0 = time.perf_counter()
            try:
                if inj_err is not None:
                    raise (inj_err.exc if inj_err.exc is not None
                           else faults.TransientFault(
                               f"injected transient error at {key}"))
                ph: Optional[list] = [] if perf_on else None
                if guard:
                    m.bump("guarded")
                    # ph passed only when armed: the disarmed call is
                    # the one test doubles wrap positionally
                    if ph is not None:
                        out = self._guarded_call(
                            fn, args, kw, deadline_s, pre_sleep, nan,
                            ph=ph)
                    else:
                        out = self._guarded_call(
                            fn, args, kw, deadline_s, pre_sleep, nan)
                else:
                    with obs.span("dispatch.run"):
                        out = fn(*args, **kw)
                    if nan:
                        out = _nan_like(out)
            except DispatchTimeout as e:
                # a hang is not worth retrying in-process: another
                # attempt costs another full deadline against a device
                # that just proved unresponsive
                m.bump("timeouts")
                sp.event("dispatch.timeout",
                         deadline_s=round(deadline_s, 3))
                self._breaker_failure(br, sp, backend)
                return self._failover(fallback, key, e, sp, fo=_fo)
            except BaseException as e:
                if _is_sticky(e):
                    # the CUDA context is gone: no retry, latch the
                    # breaker, fail over without touching the card
                    m.bump("device_lost")
                    sp.event("dispatch.device_lost",
                             error=f"{type(e).__name__}: {e}")
                    self._breaker_latch(br, sp, backend, e)
                    lost = DeviceLost(
                        f"{backend} lost its CUDA context at dispatch "
                        f"{key!r}: {type(e).__name__}: "
                        f"{str(e).splitlines()[0] if str(e) else ''}")
                    lost.__cause__ = e
                    return self._failover(fallback, key, lost, sp,
                                          fo=_fo)
                if not _is_transient(e):
                    # caller bug: no retry, no breaker verdict — but a
                    # HALF_OPEN trial must not be left dangling
                    if probing:
                        br.abort_trial()
                    raise
                m.bump("transient_errors")
                sp.event("dispatch.transient_error", attempt=attempt,
                         error=f"{type(e).__name__}: {e}")
                self._breaker_failure(br, sp, backend)
                if (br is None or not br.is_open) and \
                        attempt < retries:
                    m.bump("retries")
                    sp.event("dispatch.retry", attempt=attempt + 1)
                    time.sleep(_backoff_s(attempt))
                    attempt += 1
                    continue
                if fallback is None:
                    # a DispatchError, so the call site's failover
                    # boundary sees it
                    exhausted = RetriesExhausted(
                        f"dispatch {key!r}: {attempt + 1} transient "
                        f"failure(s): {type(e).__name__}: {e}")
                    exhausted.__cause__ = e
                    e = exhausted
                return self._failover(fallback, key, e, sp, fo=_fo)
            wall = time.perf_counter() - t0
            if br is not None:
                br.on_result(True)
            if probing:
                m.bump("breaker_recoveries")
                sp.event("breaker.closed", backend=backend)
                _log().warning(
                    "%s recovered; circuit breaker closed", backend)
            first_call = key not in self._seen
            self._seen.add(key)
            if first_call:
                # per-key first-call wall: the call the deadline
                # budgets the compile allowance for
                from pint_tpu_torch.obs import metrics as om

                om.gauge(
                    "pint_tpu_compile_wall_seconds",
                    "first-call (trace+compile+dispatch) wall per "
                    "dispatch key").set(
                    wall, scope=self.metrics.scope, key=key)
                # the same detection feeds the compile ledger: every
                # supervised dispatch key gets an entry with its
                # first-call wall
                from pint_tpu_torch.obs import perf as _perf

                _perf.note_compile(key, backend=backend,
                                   compile_wall_s=wall)
            if ph is not None and len(ph) == 3:
                # the four phases telescope over [t0, t0 + wall]:
                # queue_wait (worker spawn), host_assembly (fn up to
                # its return), device_wall (the host read and the
                # synchronize), collect (worker wake + unbox); none of
                # this feeds the RTT drift model
                t_end = t0 + wall
                qs = max(0.0, ph[0] - t0)
                ha = max(0.0, ph[1] - ph[0])
                dw = max(0.0, ph[2] - ph[1])
                co = max(0.0, t_end - ph[2])
                pkey = ("host" if pinned else backend, key)
                pf = self.metrics.perf
                pf.record(pkey, "queue_wait", qs)
                pf.record(pkey, "host_assembly", ha)
                pf.record(pkey, "device_wall", dw)
                pf.record(pkey, "collect", co)
                sp.event("perf.phases",
                         queue_wait_ms=round(qs * 1e3, 3),
                         host_assembly_ms=round(ha * 1e3, 3),
                         device_wall_ms=round(dw * 1e3, 3),
                         collect_ms=round(co * 1e3, 3),
                         depth=depth)
            # no drift verdict on the first call per key (its wall
            # includes the start-up the allowance budgets) nor for a
            # pinned (host) call, which says nothing of the device
            if not first_call and not pinned:
                self._note_wall(key, steps, wall * drift, backend,
                                depth=depth)
            self.metrics.latency.record(
                ("host" if pinned else backend, key),
                "dispatch_wall", wall)
            return out

    @staticmethod
    def _breaker_failure(br, sp, backend):
        """Report a failure to the breaker and, when that TRIPS it,
        emit the breaker.open span event and trigger a flight-recorder
        dump."""
        if br is None:
            return
        was_open = br.is_open
        br.on_result(False)
        if br.is_open and not was_open:
            from pint_tpu_torch import obs

            sp.event("breaker.open", backend=backend,
                     trips=br.trips)
            fpath = obs.flight_dump("breaker_open", backend=backend,
                                    breaker=br.snapshot())
            # one automatic profiler window capturing the dispatches
            # that follow the trip: armed by $PINT_TPU_PROFILE_DIR, one
            # per episode (per-reason rate limit), never raises
            from pint_tpu_torch.obs import perf as _perf

            _perf.auto_window("breaker_open", backend=backend,
                              flight=fpath)

    @staticmethod
    def _breaker_latch(br, sp, backend, exc):
        """Latch the breaker LOST after a sticky CUDA error, with its
        span event and flight dump."""
        if br is None:
            return
        br.latch()
        from pint_tpu_torch import obs

        sp.event("breaker.lost", backend=backend, trips=br.trips)
        obs.flight_dump("device_lost", backend=backend,
                        breaker=br.snapshot(),
                        error=f"{type(exc).__name__}: {exc}")
        _log().warning("%s lost its CUDA context (%s); breaker latched "
                       "for the life of the process", backend,
                       type(exc).__name__)

    def dispatch_async(self, fn, *args, key: str = "dispatch",
                       steps: int = 1, kw: Optional[dict] = None,
                       fallback: Optional[Callable] = None,
                       guard: Optional[bool] = None,
                       pinned: bool = False,
                       device=None) -> "DispatchFuture":
        """Issue a supervised dispatch WITHOUT waiting for it — the
        pipeline mode. Returns a ``DispatchFuture`` whose ``result()``
        delivers exactly what the synchronous ``dispatch`` would have
        returned (same retry / breaker / failover policy), so a caller
        that issues N futures and collects them all gets N completions
        — never a hung future. The deadline of each async dispatch
        scales with the in-flight depth at its issue time, and
        pipelined dispatches give no drift verdicts. Fault-plan rules
        are consumed HERE, on the caller thread, so injection follows
        issue order."""
        from pint_tpu_torch import obs

        plan = faults.active_plan()
        plan_hits = plan.faults_for(key, kinds=_DISPATCH_FAULT_KINDS) \
            if plan is not None else []
        with self._inflight_lock:
            self._inflight += 1
            depth = self._inflight
        self.metrics.bump("async_dispatches")
        self.metrics.note_inflight(depth)
        fut = DispatchFuture(key)
        ctx = obs.current()
        obs.event("dispatch.issue", key=key, depth=depth)
        mode = _torch_mode()

        def work():
            try:
                with obs.attach(ctx), _enter_mode(mode):
                    fut._set_result(self.dispatch(
                        fn, *args, key=key, steps=steps, kw=kw,
                        fallback=fallback, guard=guard, pinned=pinned,
                        depth=depth, _plan_hits=plan_hits,
                        device=device))
            except BaseException as e:
                fut._set_exception(e)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

        t = threading.Thread(target=work, daemon=True,
                             name=f"pint-dispatch-async-{key}")
        t.start()
        return fut

    # -- pipeline introspection ---------------------------------------

    @property
    def inflight(self) -> int:
        """Async dispatches issued and not yet completed."""
        with self._inflight_lock:
            return self._inflight

    def pool_health(self, pools=None, device=None) -> dict:
        """Capacity-pool health surface for the serve router: the
        device pool's breaker (keyed by ``backend_of(device)``:
        "cuda:0", or "cpu" for a CPU engine) and in-flight depth, and
        the host pool (always available: its breaker is definitionally
        closed). Read-only, never probes. ``pools`` names extra
        device-class pools, each with its own breaker keyed
        ``pool:<name>``."""
        backend = backend_of(device)
        br = breaker_for(backend)
        out = {
            "device": {
                "backend": backend,
                "breaker": br.snapshot(),
                "open": br.is_open,
                "inflight": self.inflight,
            },
            "host": {"backend": "cpu", "open": False},
        }
        for name in pools or ():
            if name in out:
                continue
            br = breaker_for(f"pool:{name}")
            out[name] = {"backend": f"pool:{name}",
                         "breaker": br.snapshot(),
                         "open": br.is_open,
                         "inflight": 0}
        return out

    def note_failover(self, key: str, exc: BaseException, sp=None):
        """Record a failover — performed by the CALL SITE (the device
        fitter swaps in the whole host fitter rather than a single
        fallback solve) or by ``_failover`` below."""
        from pint_tpu_torch import obs

        self.metrics.bump("failovers")
        err = f"{type(exc).__name__}: {exc}"
        if sp is not None:
            sp.event("dispatch.failover", key=key, error=err)
        else:
            obs.event("dispatch.failover", key=key, error=err)
        _log().warning("dispatch %s degraded to the host path: %s",
                       key, exc)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    # -- internals -----------------------------------------------------

    def _failover(self, fallback, key, exc, sp=None, fo=None):
        if fo is not None:
            fo["failover"] = True
        if fallback is None:
            raise exc
        self.note_failover(key, exc, sp=sp)
        return fallback()

    def _guarded_call(self, fn, args, kw, deadline_s, pre_sleep, nan,
                      ph: Optional[list] = None):
        """Run the dispatch on a daemon worker under the deadline. ``ph``
        (perf armed): a caller-owned list the worker fills with its
        three phase boundaries — worker start, ``fn`` return (host
        assembly and enqueue done) and the end of the host read and a
        ``torch.cuda.synchronize()`` (the device work done)."""
        from pint_tpu_torch import obs

        box: dict = {}
        done = threading.Event()
        mode = _torch_mode()
        ctx = obs.current()

        def work():
            try:
                t_start = time.perf_counter()
                if ph is not None:
                    ph.append(t_start)
                if pre_sleep:
                    # injected wedge: a real wedge never completes, so
                    # the payload is never run — the worker sleeps out
                    # the injected duration and raises into the
                    # (abandoned) box. A hang SHORTER than the
                    # deadline therefore degrades to a transient
                    # error, not a slow success.
                    time.sleep(pre_sleep)
                    raise faults.TransientFault(
                        "injected hang elapsed (dispatch abandoned)")
                # the spans take the decomposition's stamps
                run = obs.open_span("dispatch.run", parent=ctx, at=t_start)
                with obs.attach(run.ctx or ctx), _enter_mode(mode):
                    try:
                        out = fn(*args, **kw)
                    except BaseException:
                        run.end(status="error")
                        raise
                    t_run = time.perf_counter()
                    run.end(at=t_run)
                    if ph is not None:
                        ph.append(t_run)
                    # the host read INSIDE the worker: a CUDA call
                    # returns at enqueue, so without this the caller's
                    # first read would block OUTSIDE the watchdog
                    out = _host_read(out)
                    if ph is not None:
                        _sync_cuda()
                    t_read = time.perf_counter()
                    if ph is not None:
                        ph.append(t_read)
                    if run is not obs.NOOP_SPAN:
                        tr = obs.get_tracer()
                        obs.record_span("dispatch.read", tr.perf_us(t_run),
                                        tr.perf_us(t_read), parent=ctx)
                if nan:
                    out = _nan_like(out)
                box["out"] = out
            except BaseException as e:  # delivered to the caller
                box["exc"] = e
            finally:
                done.set()

        t = threading.Thread(target=work, daemon=True,
                             name="pint-dispatch-worker")
        t.start()
        if not done.wait(deadline_s):
            self.metrics.bump("abandoned_workers")
            raise DispatchTimeout(
                f"dispatch exceeded its {deadline_s:.1f}s watchdog "
                f"deadline (wedged device?); worker abandoned")
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _deadline_s(self, key, steps, backend,
                    depth: int = 1) -> float:
        """Watchdog deadline: margin x RTT x steps, scaled by the
        in-flight pipeline depth at issue, floored (1 s on the CPU,
        300 s on CUDA), plus the first-call compile allowance."""
        from pint_tpu_torch import config

        env = config.dispatch_deadline_ms()
        if env is not None:
            # the hard override is PER DISPATCH; a pipelined dispatch
            # still waits out its predecessors
            return float(env) * max(1, depth) / 1e3
        rtt = self._peek_rtt_ms(backend)
        if rtt is None:
            rtt = self._measure_rtt_guarded(backend)
        floor = _DEADLINE_FLOOR_MS if backend == "cpu" \
            else _DEADLINE_FLOOR_CUDA_MS
        dl = max(floor, _DEADLINE_MARGIN * rtt * max(1, steps)
                 * max(1, depth))
        if key not in self._seen:
            dl += config.dispatch_compile_allowance_ms()
        return dl / 1e3

    @staticmethod
    def _peek_rtt_ms(backend) -> Optional[float]:
        """The RTT the deadline/drift logic may use WITHOUT triggering a
        device measurement (the validated env override or the
        per-device cache; the CPU measures inline)."""
        from pint_tpu_torch import config

        env = config.dispatch_rtt_override_ms()
        if env is not None:
            return env
        if backend == "cpu" or backend in config._RTT_MS:
            return config.dispatch_rtt_ms(backend)
        return None

    def _measure_rtt_guarded(self, backend) -> float:
        """First RTT measurement on a CUDA device, under the watchdog
        with the probe timeout (a wedged card hangs it). A failed
        measurement caches the fallback, so later dispatches do not
        repeat the wait."""
        from pint_tpu_torch import config

        try:
            return float(self._guarded_call(
                config.dispatch_rtt_ms, (backend,), {},
                config.breaker_probe_timeout_s(), 0.0, False))
        except DispatchError:
            self.metrics.bump("timeouts")
        except Exception:
            pass
        config._RTT_MS[backend] = _RTT_FALLBACK_MS
        return _RTT_FALLBACK_MS

    def _note_wall(self, key, steps, wall_s, backend,
                   depth: int = 1):
        """RTT drift detector: an observed dispatch wall deviating >2x
        from prediction triggers a re-measure and a re-pick of the
        power-of-two K. Under-run fires against rtt alone (wall < rtt/2
        is impossible when the cached RTT is honest), over-run against
        the fully-serial bound rtt*K. Pipelined dispatches (depth > 1)
        get no verdict in either direction: their wall includes
        queuing behind the work they overlapped."""
        from pint_tpu_torch import config

        if depth > 1:
            return
        if config.dispatch_rtt_override_ms() is not None:
            # operator-pinned RTT: a re-measure would only re-read the
            # env — a verdict is pure warning churn
            return
        rtt = self._peek_rtt_ms(backend)
        if rtt is None or rtt < _DRIFT_FLOOR_MS:
            return
        wall_ms = wall_s * 1e3
        under = wall_ms < rtt / _DRIFT_FACTOR
        over = wall_ms > _DRIFT_FACTOR * rtt * max(1, steps)
        if not (under or over):
            return
        predicted_ms = rtt * max(1, steps)
        self.metrics.bump("rtt_remeasures")
        try:
            new_rtt = float(self._guarded_call(
                config.remeasure_dispatch_rtt, (backend,), {},
                config.breaker_probe_timeout_s(), 0.0, False))
        except Exception:
            return
        self.metrics.note_rtt(new_rtt,
                              config.auto_steps_per_dispatch(backend))
        from pint_tpu_torch import obs

        obs.event("rtt.remeasure", key=key,
                  wall_ms=round(wall_ms, 2),
                  predicted_ms=round(predicted_ms, 2),
                  new_rtt_ms=round(new_rtt, 2),
                  new_k=self.metrics.last_k)
        _log().warning(
            "dispatch %s wall %.1f ms vs predicted %.1f ms (>%.0fx "
            "drift): re-measured RTT %.1f ms, steps-per-dispatch "
            "re-picked to %d", key, wall_ms, predicted_ms,
            _DRIFT_FACTOR, new_rtt, self.metrics.last_k)


class DispatchFuture:
    """Handle for one pipelined supervised dispatch
    (``DispatchSupervisor.dispatch_async``). ``result()`` blocks until
    the dispatch completes and returns what the synchronous
    ``dispatch`` would have — the host FALLBACK's result included — so
    collecting every issued future is a drain guarantee. The dispatch
    runs under its own depth-scaled deadline; an optional ``timeout``
    is accepted as a second bound."""

    def __init__(self, key: str):
        self.key = key
        self._done = threading.Event()
        self._out = None
        self._exc: Optional[BaseException] = None

    def _set_result(self, out):
        self._out = out
        self._done.set()

    def _set_exception(self, exc: BaseException):
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise DispatchTimeout(
                f"async dispatch {self.key!r} did not complete "
                f"within the caller's {timeout}s result() bound")
        if self._exc is not None:
            raise self._exc
        return self._out


# ------------------------------------------------------------------
# helpers
# ------------------------------------------------------------------

# substrings marking an exception as INFRA (retry + breaker) rather
# than a caller bug
_TRANSIENT_MARKERS = ("unavailable", "resource_exhausted",
                      "deadline_exceeded", "connection", "socket",
                      "aborted", "tunnel", "failed to connect")

# the CUDA errors that destroy the process's context (every later CUDA
# call in the process fails): torch raises them as torch.AcceleratorError
# or as a RuntimeError whose text starts "CUDA error:"
_STICKY_MARKERS = ("illegal memory access", "device-side assert",
                   "unspecified launch failure", "illegal instruction",
                   "uncorrectable ecc", "misaligned address",
                   "hardware stack error", "invalid program counter")


def _is_sticky(exc: BaseException) -> bool:
    """A CUDA error that left this process's context unusable."""
    if isinstance(exc, DispatchError):
        return False
    msg = str(exc).lower()
    if type(exc).__name__ != "AcceleratorError" and \
            not (isinstance(exc, RuntimeError)
                 and msg.startswith("cuda error")):
        return False
    return any(mk in msg for mk in _STICKY_MARKERS)


def _is_transient(exc: BaseException) -> bool:
    if isinstance(exc, faults.TransientFault):
        return True
    # deliberately NOT bare OSError: FileNotFoundError/PermissionError
    # etc. are caller bugs that must re-raise, not retry/trip breakers
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    # torch.cuda.OutOfMemoryError: the allocator may free in time (the
    # reference's RESOURCE_EXHAUSTED)
    return type(exc).__name__ == "OutOfMemoryError"


def _backoff_s(attempt: int) -> float:
    """Jittered exponential backoff (base $PINT_TPU_DISPATCH_BACKOFF_MS)."""
    import random

    from pint_tpu_torch import config

    base = config.dispatch_backoff_ms() / 1e3 * (2 ** attempt)
    return base * (1.0 + 0.5 * random.random())


def _torch_mode():
    """(grad enabled, inference mode) of the calling thread, or None
    when torch is not imported (thread-local state a worker must
    re-enter)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    return torch.is_grad_enabled(), torch.is_inference_mode_enabled()


@contextlib.contextmanager
def _enter_mode(mode):
    """Re-enter a captured (grad, inference) mode on this thread."""
    if mode is None:
        yield
        return
    import torch

    grad, inf = mode
    with torch.inference_mode(inf), torch.set_grad_enabled(grad):
        yield


def _tree_map(fn, out):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(_tree_map(fn, x) for x in out)
    if isinstance(out, list):
        return [_tree_map(fn, x) for x in out]
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    return fn(out)


def _sync_cuda():
    """``torch.cuda.synchronize()`` when this process has a CUDA context
    (the perf decomposition's end of the device wall: a result with no
    CUDA tensor leaves the host read nothing to wait for)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _host_read(out):
    """Every CUDA tensor leaf of ``out`` (tuples, lists and dicts) as a
    CPU tensor: ``.cpu()`` synchronizes, so the read is the end of the
    device work. CPU tensors, numpy arrays and other leaves pass
    through untouched."""
    torch = sys.modules.get("torch")
    if torch is None:
        return out

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.cpu()
        return x

    return _tree_map(leaf, out)


def _nan_like(out):
    """Injected-NaN transform: every floating leaf (torch tensor, numpy
    array or Python float) becomes all-NaN — what a dying device's
    garbage readback looks like downstream."""
    import numpy as np

    torch = sys.modules.get("torch")

    def leaf(x):
        if torch is not None and isinstance(x, torch.Tensor):
            return torch.full_like(x, float("nan")) \
                if x.is_floating_point() else x
        if isinstance(x, (np.ndarray, np.generic, float)):
            a = np.asarray(x)
            if np.issubdtype(a.dtype, np.floating):
                return np.full_like(a, np.nan)
        return x

    return _tree_map(leaf, out)


def _log():
    from pint_tpu_torch.logging import log

    return log


# ------------------------------------------------------------------
# process-global supervisor + test reset
# ------------------------------------------------------------------

_GLOBAL: Optional[DispatchSupervisor] = None
_GLOBAL_LOCK = locks.make_lock("runtime.global_supervisor")


def get_supervisor() -> DispatchSupervisor:
    """The process-global supervisor used by the fitters and the array
    paths (breakers are shared with any other instance)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = DispatchSupervisor()
        return _GLOBAL


def reset_runtime():
    """Drop all breakers + reset the global supervisor's counters
    (tests: a tripped breaker must never leak into the next test). A
    LOST breaker goes too: call this only in a process whose CUDA
    context is intact."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.metrics = RuntimeMetrics()
            _GLOBAL._seen.clear()
