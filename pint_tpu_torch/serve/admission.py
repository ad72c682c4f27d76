"""Admission control: per-tenant token-bucket quotas + deadline-aware
load shedding + in-queue deadline expiry (a port of
pint_tpu/serve/admission.py; host code, copied).

Every shed decision is EXPLICIT, LABELED, and policy-driven:

- **per-tenant token buckets** (``config.tenant_qps`` /
  ``$PINT_TPU_TENANT_QPS``, burst ``$PINT_TPU_TENANT_BURST``): each
  tenant refills at the configured rate; a drained bucket sheds with
  ``TenantOverQuota`` without touching shared capacity — one bursting
  tenant cannot starve the rest. Rate 0 (default) disables the
  bookkeeping entirely.
- **deadline-aware shedding** (``config.shed_policy``,
  ``$PINT_TPU_SHED_POLICY``): at capacity, shed the request that will
  miss its deadline ANYWAY — a queued request whose remaining budget
  is smaller than the router-predicted wait (or the newcomer itself,
  by the same test) — and never one that can still make it. Only when
  nobody is provably doomed does the submit degrade to plain
  backpressure rejection ("reject" restores plain backpressure
  unconditionally).
- **in-queue expiry** (the ``shed_expired`` counter): requests whose
  deadline passes while still queued are failed with
  ``DeadlineExceeded`` at the next admission or drain touch, not
  discovered dispatch-time after the batch already padded around
  them.

Fault hooks (``runtime.faults``, new kinds): an active plan's
``overload`` rule makes matching admissions see exhausted capacity
(exercising the shed policy without a real burst); ``tenant_burst``
drains the matching tenant's bucket on demand. Both are consumed
HERE, at admission — the dispatch supervisor never sees them.

Counters live on the controller and are embedded in
``ServeMetrics.snapshot()`` as the ``admission`` block — a shed
request is always visible in the artifact, never a silent drop.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from pint_tpu_torch.runtime import faults, locks

__all__ = ["TokenBucket", "AdmissionController"]

# shed-burst flight trigger: >= _BURST_N sheds inside
# _BURST_WINDOW_S dumps the tracer ring to $PINT_TPU_FLIGHT_DIR —
# a sustained shed storm is an incident, a lone deadline miss is not
_BURST_N = 16
_BURST_WINDOW_S = 5.0


class TokenBucket:
    """The classic token bucket: ``rate`` tokens/s refill up to
    ``burst`` capacity; ``take`` consumes one if available. Time is
    injected (monotonic seconds) so tests are deterministic."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = None  # first take() anchors the clock

    def take(self, now: float) -> bool:
        if self._last is None:
            self._last = now
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def drain(self):
        """Empty the bucket (the ``tenant_burst`` fault hook)."""
        self.tokens = 0.0


class AdmissionController:
    """Admission policy + shed accounting for one ServeEngine.

    The engine calls ``check_quota`` before classifying (a
    quota-shed request must not pay GLS assembly), and
    ``shed_decision`` when the queue is at capacity. Thread-safe: the
    engine may call from its submit path and its drain loop
    concurrently."""

    def __init__(self, tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 policy: Optional[str] = None):
        from pint_tpu_torch import config

        self.tenant_qps = config.tenant_qps() \
            if tenant_qps is None else max(0.0, float(tenant_qps))
        self.tenant_burst = (config.tenant_burst()
                             if tenant_burst is None
                             else max(1.0, float(tenant_burst)))
        self.policy = config.shed_policy() if policy is None \
            else str(policy)
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = locks.make_lock("serve.admission")
        # shed accounting (the admission block of the metrics
        # snapshot): every decision that drops a request lands in
        # exactly one of these. the counters are bound
        # children of the process metric registry
        # (pint_tpu_admission_*_total, scope-labelled) and the
        # attribute reads below are derived views — mutation goes
        # through bump() only.
        from pint_tpu_torch.obs import metrics as om

        self.scope = om.new_scope("adm")
        self._c = {
            name: om.counter(
                f"pint_tpu_admission_{name}_total",
                f"admission {name.replace('_', ' ')}"
            ).child(scope=self.scope)
            for name in self._COUNTERS}
        # per-tenant admit/shed accounting as a labelled counter
        self._tenant_counter = om.counter(
            "pint_tpu_admission_tenant_total",
            "per-tenant admission outcomes")
        self._tenant_names: set = set()
        # aggregate shed stream, labelled by kind — fed by note_shed
        # (called next to every shed counter bump); the shed-rate
        # SLO's numerator
        self._shed_total = om.counter(
            "pint_tpu_serve_shed_total",
            "sheds by kind (quota/deadline/expired/overload)")
        # recent shed stamps for the burst detector (bounded deque —
        # the detector needs only the last _BURST_N arrivals)
        self._shed_times: collections.deque = collections.deque(
            maxlen=_BURST_N)

    _COUNTERS = ("shed_expired", "shed_deadline", "shed_quota",
                 "shed_overload", "shed_shutdown",
                 "injected_overload", "shed_bursts")

    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in type(self)._COUNTERS:
            return int(c[name].value())
        raise AttributeError(name)

    def bump(self, name: str, n: int = 1):
        """The ONE mutation surface for the admission counters."""
        self._c[name].inc(n)

    @property
    def tenants(self) -> Dict[str, dict]:
        """Derived per-tenant view of the labelled registry counter
        (snapshot-compatible with a plain dict)."""
        with self._lock:
            names = sorted(self._tenant_names)
        return {name: {
            "admitted": int(self._tenant_counter.value(
                scope=self.scope, tenant=name, outcome="admitted")),
            "shed": int(self._tenant_counter.value(
                scope=self.scope, tenant=name, outcome="shed")),
        } for name in names}

    def note_shed(self, kind: str):
        """Record one shed for the burst detector; a burst (>=
        ``_BURST_N`` sheds inside ``_BURST_WINDOW_S``) triggers a
        flight-recorder dump (rate-limited by the recorder itself).
        Called next to every shed counter bump — quota, deadline,
        expiry, overload. Several of those call sites hold the
        ENGINE lock (submit's shed paths, the expiry sweeps), and a
        shed storm is exactly when stalling admission behind a disk
        fsync would hurt most — so the dump itself runs on a
        detached daemon thread (bounded: one per burst trigger,
        which the recorder rate-limits to one per 10 s per reason)."""
        now = time.monotonic()
        self._shed_total.inc(scope=self.scope, kind=kind)
        with self._lock:
            self._shed_times.append(now)
            burst = (len(self._shed_times) == _BURST_N
                     and now - self._shed_times[0] <= _BURST_WINDOW_S)
            if burst:
                self._c["shed_bursts"].inc()
                self._shed_times.clear()
        if burst:
            from pint_tpu_torch import obs

            obs.event("serve.shed_burst", kind=kind, n=_BURST_N,
                      window_s=_BURST_WINDOW_S)

            def dump():
                obs.flight_dump("shed_burst", last_kind=kind,
                                admission=self.snapshot())

            threading.Thread(target=dump, daemon=True,
                             name="pint-shed-burst-dump").start()

    # -- per-tenant quotas ---------------------------------------------

    def _note_tenant(self, name: str, outcome: str):
        """One tenant admission outcome into the labelled registry
        counter (the ``tenants`` property is its derived view).
        Caller holds ``self._lock`` (for the name set only — the
        counter has its own lock)."""
        self._tenant_names.add(name)
        self._tenant_counter.inc(scope=self.scope, tenant=name,
                                 outcome=outcome)

    def check_quota(self, tenant: Optional[str],
                    now: Optional[float] = None) -> bool:
        """True = within quota (token consumed). Also consumes the
        fault plan's ``tenant_burst`` rules: a matching rule drains
        the tenant's bucket first, so the NEXT take fails
        deterministically."""
        name = tenant or "default"
        plan = faults.active_plan()
        burst_hit = False
        if plan is not None:
            burst_hit = bool(plan.faults_for(
                f"serve.admit/{name}", kinds=("tenant_burst",)))
        if self.tenant_qps <= 0.0 and not burst_hit:
            return True
        with self._lock:
            b = self._buckets.get(name)
            if b is None:
                b = self._buckets[name] = TokenBucket(
                    max(self.tenant_qps, 0.0), self.tenant_burst)
            if burst_hit:
                b.drain()
            ok = b.take(time.monotonic() if now is None else now)
            if ok:
                self._note_tenant(name, "admitted")
            else:
                self._note_tenant(name, "shed")
                self._c["shed_quota"].inc()
        if not ok:
            self.note_shed("quota")
        return ok

    # -- capacity / shedding -------------------------------------------

    def capacity_exhausted(self, queued: int, cap: int) -> bool:
        """Queue-full test, including the fault plan's ``overload``
        rules (an injected overload makes THIS admission see a full
        queue regardless of the real depth)."""
        plan = faults.active_plan()
        if plan is not None and plan.faults_for(
                "serve.admit/capacity", kinds=("overload",)):
            self._c["injected_overload"].inc()
            return True
        return queued >= cap

    def shed_decision(self, newcomer, queued_waits,
                      newcomer_wait_s: float, now: float):
        """At-capacity policy decision. Returns one of

        - ``("victim", req)``: shed the queued ``req`` — it cannot
          make its deadline anyway — and admit the newcomer;
        - ``("newcomer", None)``: the newcomer itself cannot make its
          deadline; shed it (its future is failed, nothing raised);
        - ``("reject", None)``: nobody is provably doomed —
          backpressure-reject the newcomer (``ServeOverload``).

        ``queued_waits`` is ``[(req, predicted_wait_s)]`` with each
        wait computed POSITION-AWARE by the engine (only rows ahead
        of the candidate count — one prefix-sum pass, so the
        at-capacity decision stays O(n) under the engine lock);
        ``newcomer_wait_s`` is the same estimate for the newcomer.
        "Doomed" = remaining deadline budget < predicted wait. The
        policy NEVER sheds a request that can still make its
        deadline."""
        if self.policy == "reject":
            return ("reject", None)
        for r, wait in queued_waits:
            if r.expires_at is None:
                continue
            if r.expires_at - now < wait:
                return ("victim", r)
        if newcomer.deadline_s is not None and \
                float(newcomer.deadline_s) < newcomer_wait_s:
            return ("newcomer", None)
        return ("reject", None)

    # -- reporting -----------------------------------------------------

    def snapshot(self) -> dict:
        # no self._lock here: every field is a registry read with
        # its own metric lock (the tenants property takes self._lock
        # for the name set) — a snapshot must never serialize behind
        # the admission hot path
        return {
            "policy": self.policy,
            "tenant_qps": self.tenant_qps,
            "shed_expired": self.shed_expired,
            "shed_deadline": self.shed_deadline,
            "shed_quota": self.shed_quota,
            "shed_overload": self.shed_overload,
            "shed_shutdown": self.shed_shutdown,
            "shed_bursts": self.shed_bursts,
            "injected_overload": self.injected_overload,
            "tenants": {k: dict(v)
                        for k, v in sorted(self.tenants.items())},
        }

    @property
    def total_shed(self) -> int:
        return (self.shed_expired + self.shed_deadline +
                self.shed_quota + self.shed_overload +
                self.shed_shutdown)
