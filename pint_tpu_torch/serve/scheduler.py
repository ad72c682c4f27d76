"""Continuous-batching request scheduler: admission pipeline ->
open shape-class buckets -> routed, padded, batched dispatches (a port
of pint_tpu/serve/scheduler.py: the host logic is the reference's, the
dispatches run the batched torch class programs of ``serve.bucket`` on
the engine's device, the GPU by default).

Requests are admitted in-flight into *open* shape-class buckets
between drain windows. A bucket seals (becomes a dispatch unit) when
it fills to ``max_batch`` or its coalescing window expires; sealed
units dispatch while new arrivals keep landing in freshly opened
buckets — admission never stops for a drain. A burst of K compatible
requests pays one dispatch instead of K; the shapes the card sees stay
bounded by the shape-class count, never the request count.

Admission pipeline (``serve.admission``), in order:

1. **tenant quota**: per-tenant token buckets
   (``$PINT_TPU_TENANT_QPS`` / ``_BURST``) shed a bursting tenant
   with ``TenantOverQuota`` before any assembly work is spent;
2. **classification**: the request is assembled and assigned its
   shape class;
3. **in-queue expiry**: requests whose deadline passed while queued
   are failed with ``DeadlineExceeded`` NOW (the ``shed_expired``
   counter), not discovered at dispatch;
4. **capacity + shed policy** (``$PINT_TPU_SHED_POLICY``): at
   capacity, the deadline-aware policy sheds the request that will
   miss its deadline anyway — a doomed queued victim, or the doomed
   newcomer itself — and never one that can still make it; with no
   provably-doomed request the submit is backpressure-rejected
   (``ServeOverload``).

Dispatch routing (``serve.router``): every sealed unit is placed by
the breaker-aware capacity router — the host CPU and the card are
CONCURRENT pools with learned per-pool service rates; an OPEN device
breaker demotes the device pool (units route straight to the host
mirrors as planned capacity, pinned and hang-free) instead of every
dispatch paying the watchdog-timeout-then-failover dance.

Crash-safe restart (``serve.journal``): with a journal, every
payload-carrying admission is recorded before dispatch and
acknowledged on completion; with an AOT dir, each shape class is
recorded after its first device dispatch and primed at engine
construction, so a restarted engine's first request adds no new class
and ``replay()`` re-submits exactly the unacknowledged journal
entries. ``stop(timeout=...)`` drains gracefully: queued work keeps
dispatching until the bound, the remainder is shed with an explicit
``ShutdownShed`` per request, and the serve-state snapshot is written.

Every device dispatch routes through the engine's
``runtime.DispatchSupervisor`` (watchdog deadline, circuit breaker,
host failover), and every shed/quota/reroute/replay decision is
LABELED in the metrics snapshot (``admission``/``router``/``restart``
blocks) — degraded serving is visible, never silent.
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import List, Optional, Tuple

import numpy as np

from pint_tpu_torch import obs, resolve_device
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.profiling import annotate
from pint_tpu_torch.runtime import faults, locks
from pint_tpu_torch.serve.admission import AdmissionController
from pint_tpu_torch.serve.bucket import (
    ExecutableCache,
    append_shape_class,
    gls_shape_class,
    gwb_shape_class,
    pad_dim,
    phase_shape_class,
    posterior_shape_class,
    pow2_ceil,
)
from pint_tpu_torch.serve.metrics import ServeMetrics
from pint_tpu_torch.serve.request import (
    AppendResult,
    AppendTOAsRequest,
    DeadlineExceeded,
    EngineKilled,
    FitStepRequest,
    FitStepResult,
    GWBRequest,
    GWBResult,
    PhasePredictRequest,
    PhasePredictResult,
    PosteriorRequest,
    PosteriorResult,
    ResidualsRequest,
    ResidualsResult,
    ServeOverload,
    ShutdownShed,
    TenantOverQuota,
)
from pint_tpu_torch.serve.router import CapacityRouter

__all__ = ["ServeEngine", "ServeGLSFitter"]


class _OpenBucket:
    """One open shape-class bucket: requests accumulate here between
    seal events (full batch / window expiry / explicit flush)."""

    __slots__ = ("key", "reqs", "opened_at", "fallback")

    def __init__(self, key, opened_at: float, fallback: bool):
        self.key = key
        self.reqs: List = []
        self.opened_at = opened_at
        self.fallback = fallback


class ServeEngine:
    """The serving engine: admission pipeline, open buckets,
    capacity router, executable cache, journal, metrics. One engine
    per served deployment; its compile accounting
    (``metrics.compile_count``) is self-contained.

    ``device`` is where every device-pool dispatch runs (None means
    "cuda"; a CPU engine passes "cpu"). ``mesh`` (``pta.shard.Mesh``)
    splits every GLS, phase and append dispatch's batch axis into
    contiguous per-device blocks over the mesh's ``axis``, and GWB
    requests assemble their blocks the same way; batch slots then pad
    to a mesh multiple, and ``device`` defaults to the mesh's first
    device. ``aot_dir``/``journal`` arm the
    crash-safe restart path (defaults from ``$PINT_TPU_AOT_DIR`` /
    ``$PINT_TPU_JOURNAL``).
    """

    def __init__(self, window_s: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 bucket_edges: Optional[Tuple[int, ...]] = None,
                 mesh=None, axis: str = "pulsar",
                 pipeline_depth: Optional[int] = None,
                 tenant_qps: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 shed_policy: Optional[str] = None,
                 aot_dir: Optional[str] = None,
                 journal=None,
                 worker_id: Optional[str] = None,
                 pools: Optional[Tuple[str, ...]] = None,
                 device=None):
        from pint_tpu_torch import config
        from pint_tpu_torch.pta.shard import mesh_devices
        from pint_tpu_torch.runtime import DispatchSupervisor

        home = None if mesh is None else mesh_devices(mesh, axis)[0]
        self.device = resolve_device(device) \
            if home is None or device is not None else home

        self.window_s = config.serve_window_s() \
            if window_s is None else float(window_s)
        self.max_batch = config.serve_max_batch() \
            if max_batch is None else int(max_batch)
        self.queue_cap = config.serve_queue_cap() \
            if queue_cap is None else int(queue_cap)
        self.bucket_edges = tuple(sorted(
            config.serve_bucket_edges() if bucket_edges is None
            else bucket_edges))
        self.mesh = mesh
        self.axis = axis
        # pipelined drain: keep up to this many sealed
        # units IN FLIGHT while draining — unit k+1 is issued on the
        # supervisor's async pipeline while unit k executes. 1 = the
        # classic synchronous drain.
        self.pipeline_depth = max(1, config.serve_pipeline_depth()
                                  if pipeline_depth is None
                                  else int(pipeline_depth))
        # engine-owned dispatch supervisor: its counters (timeouts,
        # failovers, retries) are this deployment's — self-contained
        # like the compile accounting — while breaker state stays
        # process-global (backend health is a process fact)
        self.supervisor = DispatchSupervisor()
        self.admission = AdmissionController(
            tenant_qps=tenant_qps, tenant_burst=tenant_burst,
            policy=shed_policy)
        # fleet identity: stamped onto every journaled
        # admit so the fleet front can re-home exactly this worker's
        # unacked set when its lease expires; None = classic
        # single-worker engine, admits carry no owner.
        self.worker_id = worker_id
        self.router = CapacityRouter(supervisor=self.supervisor,
                                     pools=pools, device=self.device)
        if aot_dir is None:
            aot_dir = config.aot_dir()
        self.cache = ExecutableCache(mesh=mesh, axis=axis,
                                     supervisor=self.supervisor,
                                     aot_dir=aot_dir,
                                     device=self.device)
        # journal: a path (str), a prebuilt RequestJournal, or None
        # (default $PINT_TPU_JOURNAL). A prebuilt journal is NOT
        # owned: a fleet shares one journal across workers, and one
        # worker's stop() must not close it under the others.
        if journal is None:
            journal = config.journal_path()
        self._journal_owned = journal is None or isinstance(journal,
                                                            str)
        if isinstance(journal, str):
            from pint_tpu_torch.serve.journal import RequestJournal

            journal = RequestJournal(journal)
        self.journal = journal
        self.metrics = ServeMetrics(self.cache,
                                    supervisor=self.supervisor,
                                    pipeline_depth=self.pipeline_depth,
                                    donation=self.cache.donation,
                                    admission=self.admission,
                                    router=self.router)
        self.metrics.restart_info = self._restart_info(aot_dir)
        # per-pulsar cached accumulated normal equations:
        # the AppendTOAsRequest state registry — in-memory, delta
        # commits under its own lock at collect time
        from pint_tpu_torch.serve.append import AppendStore

        self.append_store = AppendStore()
        self.metrics.append_store = self.append_store
        self._open: dict = {}                  # key -> _OpenBucket
        self._ready: collections.deque = collections.deque()
        self._pool_last_collect: dict = {}     # pool -> last collect t
        self._nqueued = 0
        self._earliest_expiry: Optional[float] = None
        self._dead = False
        self._drain_stop_at: Optional[float] = None  # shutdown bound
        # the ENGINE lock (admission-critical): every submitter
        # serializes on it, so a supervised dispatch / journal fsync
        # / host solve under it stalls admission — engine=True arms
        # the runtime.locks dispatch-clear check
        self._lock = locks.make_rlock("serve.engine", engine=True)
        self._cv = locks.make_condition(self._lock)
        # the dispatch SERIALIZER: sealed units issue/collect while
        # holding it BY DESIGN (one drain at a time; _cv is released
        # per iteration so admission keeps flowing) — deliberately
        # NOT engine-marked
        self._dispatch_lock = locks.make_lock("serve.dispatch")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # arm the SLO burn-rate watchdog when $PINT_TPU_SLO
        # is set (a no-op otherwise — no thread, no ring); it samples
        # the process metric registry this engine now writes through
        from pint_tpu_torch.obs import slo as _slo

        _slo.maybe_start()

    def _restart_info(self, aot_dir) -> dict:
        info = {"warm": False, "replayed": 0}
        if self.cache.aot is not None:
            info["aot"] = self.cache.aot.snapshot()
            info["warm"] = self.cache.aot.restored > 0
            from pint_tpu_torch.serve.journal import load_state

            prior = load_state(aot_dir)
            if prior is not None:
                info["prior_shutdown"] = prior.get("reason")
        if self.journal is not None:
            info["journal"] = self.journal.counts()
        return info

    # -- admission -----------------------------------------------------

    def submit(self, req):
        """Run one request through the admission pipeline; returns
        its ServeFuture. Raises ``TenantOverQuota`` when the tenant's
        token bucket is drained and ``ServeOverload`` when capacity
        is exhausted and the shed policy found nobody provably doomed
        (backpressure — nothing is partially accepted). A
        deadline-doomed newcomer is NOT raised: its future is failed
        with ``DeadlineExceeded`` and returned (a labeled shed
        response, not a transport error).

        Tracing: every submit opens the request's ROOT
        span ("serve.request", a fresh trace id) before any
        admission decision, and the request resolves to exactly one
        terminal event (served / shed:* / failed) — either here on a
        raise-path shed, or from the future's done callback. Queue
        wait, dispatch and ack spans attach under this root as the
        request moves through the engine."""
        if self._dead:
            raise EngineKilled(
                "engine was killed (kill_restart); restart and "
                "replay the journal")
        # every live submit is an ATTEMPT, counted before any shed
        # decision — the shed-rate SLO's denominator (quota/overload
        # sheds never reach `submitted`)
        self.metrics.bump("attempts")
        osp = obs.open_root("serve.request", label="req",
                            kind=req.kind,
                            tenant=req.tenant or "default",
                            rid=req.rid)
        req._osp = osp
        if osp.ctx is not None:
            self._wire_terminal_span(req, osp)
        now = time.monotonic()
        # 1. tenant quota — before classification, so a shed tenant
        # never costs GLS assembly work
        if not self.admission.check_quota(req.tenant, now=now):
            osp.event("serve.terminal", status="shed:quota")
            osp.end(status="shed:quota")
            raise TenantOverQuota(
                f"tenant {req.tenant or 'default'!r} is over its "
                f"{self.admission.tenant_qps}/s quota; shed")
        # 2. classification (assembles GLS problems — outside any
        # lock; the request object is single-submitter by contract)
        try:
            key, fb = self._class_of(req)
        except Exception as e:
            self.metrics.bump("submitted")
            self.metrics.bump("failed")
            req.future.set_exception(e)
            return req.future
        with self._cv:
            now = time.monotonic()
            # 3. in-queue expiry sweep (amortized: no-op until the
            # earliest queued deadline has actually passed)
            self._expire_locked(now)
            # 4. capacity + shed policy
            if self.admission.capacity_exhausted(self._nqueued,
                                                 self.queue_cap):
                verdict, victim = self.admission.shed_decision(
                    req, self._queued_waits_locked(),
                    self._predicted_wait_locked(req), now)
                if verdict == "victim":
                    self._remove_queued_locked(victim)
                    self.admission.bump("shed_deadline")
                    self.admission.note_shed("deadline")
                    victim.future.set_exception(DeadlineExceeded(
                        f"{victim.kind} request shed at admission: "
                        f"predicted wait exceeds its remaining "
                        f"{victim.deadline_s}s deadline (doomed "
                        f"anyway; capacity given to a request that "
                        f"can still make it)"))
                elif verdict == "newcomer":
                    self.admission.bump("shed_deadline")
                    self.admission.note_shed("deadline")
                    self.metrics.bump("submitted")
                    req.future.set_exception(DeadlineExceeded(
                        f"{req.kind} request shed at admission: "
                        f"predicted wait exceeds its {req.deadline_s}"
                        f"s deadline (would miss anyway)"))
                    return req.future
                else:
                    self.metrics.bump("rejected")
                    self.admission.bump("shed_overload")
                    self.admission.note_shed("overload")
                    osp.event("serve.terminal",
                              status="shed:overload")
                    osp.end(status="shed:overload")
                    raise ServeOverload(
                        f"admission queue full ({self.queue_cap}); "
                        f"shed load or raise "
                        f"PINT_TPU_SERVE_QUEUE_CAP")
            # admitted: stamp, journal, place into its open bucket
            req.admitted_at = now
            osp.event("serve.admit", queued=self._nqueued + 1)
            if req.deadline_s is not None:
                req.expires_at = now + float(req.deadline_s)
                if self._earliest_expiry is None or \
                        req.expires_at < self._earliest_expiry:
                    self._earliest_expiry = req.expires_at
            if self._thread is None:
                # synchronous mode: result() pumps the queue itself
                req.future._sync_engine = self
            b = self._open.get(key)
            if b is None:
                b = self._open[key] = _OpenBucket(key, now, fb)
            b.reqs.append(req)
            self._nqueued += 1
            if len(b.reqs) >= self.max_batch:
                self._seal_locked(key)
            self.metrics.bump("submitted")
            self.metrics.queue_depth(self._nqueued)
            self._cv.notify()
        # journal OUTSIDE the engine lock: the per-admit fsync must
        # not serialize other submitters or the drain loop's seal/
        # expire work behind disk latency. The request may even
        # complete before the admit line lands (threaded drain) —
        # the ack callback fires immediately on a done future and
        # the journal scan matches admit/ack lines in any order.
        self._journal_admit(req)
        return req.future

    @staticmethod
    def _terminal_status(fut) -> str:
        """Classify a RESOLVED future into its terminal trace label —
        the same taxonomy the journal ack uses."""
        try:
            fut.result(timeout=0)
            return "served"
        except DeadlineExceeded:
            return "shed:deadline"
        except ShutdownShed:
            return "shed:shutdown"
        except TenantOverQuota:
            return "shed:quota"
        except ServeOverload:
            return "shed:overload"
        except EngineKilled:
            return "killed"
        except Exception:
            return "failed"

    def _wire_terminal_span(self, req, osp):
        """Close the request's root span with its terminal status
        when the future resolves — every admitted request ends in
        exactly one of served / shed:* / failed / killed (the
        zero-orphan contract the chaos oracle asserts)."""

        def _terminal(fut, osp=osp):
            status = self._terminal_status(fut)
            osp.event("serve.terminal", status=status)
            osp.end(status=status)

        req.future.add_done_callback(_terminal)

    def _journal_admit(self, req):
        if self.journal is None or req.payload is None:
            return
        if req.rid is None:
            req.rid = uuid.uuid4().hex
        # a replayed entry already HAS its admit line (plus the
        # "replayed" progress mark) — writing another would grow the
        # journal by the full payload and double-count `admitted`
        # on every restart; only its terminal ack below is owed
        if not getattr(req, "_journal_replayed", False):
            self.journal.admit(req.rid, req.payload,
                               tenant=req.tenant,
                               deadline_s=req.deadline_s,
                               worker=self.worker_id)
        journal = self.journal

        osp = getattr(req, "_osp", None)

        def _ack(fut, rid=req.rid):
            # the ONE exception->status classifier (shared with the
            # trace terminal event, so journal and trace vocabularies
            # can never drift). "killed" is deliberately NOT acked:
            # the kill_restart contract is that journal entries stay
            # unacknowledged — a killed engine's work must replay
            st = self._terminal_status(fut)
            if st == "killed":
                return
            journal.ack(rid, st)
            if osp is not None:
                osp.event("serve.journal_ack", status=st)

        req.future.add_done_callback(_ack)

    def replay(self, factory, owner: Optional[str] = None,
               records: Optional[List[dict]] = None) -> List:
        """Re-submit every unacknowledged journal entry (crash
        recovery): ``factory(payload)`` rebuilds the request from
        the journaled payload. Returns the new futures, in journal
        order. Each entry gets a non-terminal "replayed" progress
        mark; its terminal ack lands when the replayed future
        resolves — a crash DURING replay leaves it replayable.

        ``owner`` scopes the replay set to one worker's admits (the
        fleet re-home path — a survivor must NOT replay its own
        in-flight entries); ``records`` replays an explicit
        already-scanned set instead (the fleet front scans once,
        writes the ``rehome`` marks, then hands the records here)."""
        if self.journal is None:
            return []
        if records is None:
            records = self.journal.unacknowledged(owner=owner)
        futs = []
        for rec in records:
            req = factory(rec["payload"])
            req.rid = rec["rid"]
            if req.payload is None:
                req.payload = rec["payload"]
            req._journal_replayed = True
            self.journal.ack(rec["rid"], "replayed")
            futs.append(self.submit(req))
        self.metrics.restart_info["replayed"] = self.metrics.restart_info.get("replayed", 0) + len(futs)  # graftlint: allow G13 -- restart_info is the labeled restart-summary dict on the snapshot surface, not registry counter state; it accumulates because a fleet re-home may call replay() several times on one survivor
        return futs

    # -- queue bookkeeping (all under self._lock) ----------------------

    def _queued_requests_locked(self):
        for b in self._open.values():
            yield from b.reqs
        for _, grp in self._ready:
            yield from grp

    def _remove_queued_locked(self, req):
        for key, b in list(self._open.items()):
            if req in b.reqs:
                b.reqs.remove(req)
                self._nqueued -= 1
                if not b.reqs:
                    del self._open[key]
                return
        for unit in self._ready:
            if req in unit[1]:
                unit[1].remove(req)
                self._nqueued -= 1
                return

    @staticmethod
    def _kind_of(req) -> str:
        if isinstance(req, PhasePredictRequest):
            return "phase"
        if isinstance(req, PosteriorRequest):
            return "posterior"
        if isinstance(req, AppendTOAsRequest):
            return "append"
        if isinstance(req, GWBRequest):
            return "gwb"
        return "gls"

    def _predicted_wait_locked(self, req) -> float:
        """Admission-policy wait estimate for a NEWCOMER: every
        already-sealed unit dispatches before it, plus the router's
        in-flight backlog, each KIND costed at its own learned
        (pool, kind) rate (0.0 — never doomed — until the newcomer's
        own kind has an observed rate; a queued
        posterior chain is priced at the posterior rate, so a heavy
        chain ahead dooms a tight-deadline newcomer honestly, and a
        GLS-speed estimate never admits a long chain against a
        deadline it cannot make). Open-bucket rows are excluded:
        their seal order vs the newcomer's own bucket is not
        knowable, and overestimating the wait would shed a request
        that could still make its deadline."""
        ahead: dict = {}
        for _, grp in self._ready:
            for r in grp:
                k = self._kind_of(r)
                ahead[k] = ahead.get(k, 0) + self._rows_of(r)
        return self.router.predicted_wait_s(
            self._rows_of(req), kind=self._kind_of(req),
            ahead_by_kind=ahead)

    def _queued_waits_locked(self):
        """``[(req, predicted_wait_s)]`` for every queued request,
        ONE O(n) prefix-sum pass in dispatch order. A queued
        candidate's wait counts only rows AHEAD of it — sealed units
        dispatch in deque order, batch-mates ride the same batched
        dispatch, and rows queued BEHIND a candidate must not count
        (the inflated wait would shed a head-of-queue request that
        was about to be served on time). The prefix sum is PER KIND
        (rows are kind-local units — walker-steps for posterior —
        and the router costs each kind at its own rate). Open-bucket
        requests dispatch after every sealed unit; other open
        buckets are excluded, same never-overestimate rule as
        above."""
        out = []
        ahead: dict = {}
        for _, grp in self._ready:
            for r in grp:
                out.append((r, self.router.predicted_wait_s(
                    self._rows_of(r), kind=self._kind_of(r),
                    ahead_by_kind=dict(ahead))))
            for r in grp:
                k = self._kind_of(r)
                ahead[k] = ahead.get(k, 0) + self._rows_of(r)
        for b in self._open.values():
            for r in b.reqs:
                out.append((r, self.router.predicted_wait_s(
                    self._rows_of(r), kind=self._kind_of(r),
                    ahead_by_kind=dict(ahead))))
        return out

    def _expire_locked(self, now: float):
        """Fail every queued request whose deadline has passed
        (satellite: deadlines used to be checked only at
        drain/dispatch time — a doomed request could sit in the queue
        consuming capacity long after its caller gave up). Amortized:
        skips entirely until the earliest queued expiry is due."""
        if self._earliest_expiry is None or now < self._earliest_expiry:
            return
        earliest = None

        def sweep(reqs: List) -> List:
            nonlocal earliest
            live = []
            for r in reqs:
                if r.expired(now):
                    self._nqueued -= 1
                    self.metrics.bump("deadline_missed")
                    self.admission.bump("shed_expired")
                    self.admission.note_shed("expired")
                    r.future.set_exception(DeadlineExceeded(
                        f"{r.kind} request missed its "
                        f"{r.deadline_s}s deadline in queue"))
                else:
                    if r.expires_at is not None and \
                            (earliest is None
                             or r.expires_at < earliest):
                        earliest = r.expires_at
                    live.append(r)
            return live

        for key, b in list(self._open.items()):
            b.reqs[:] = sweep(b.reqs)
            if not b.reqs:
                del self._open[key]
        for unit in list(self._ready):
            unit[1][:] = sweep(unit[1])
            if not unit[1]:
                self._ready.remove(unit)
        self._earliest_expiry = earliest
        self.metrics.queue_depth(self._nqueued)

    def _seal_locked(self, key):
        """Seal one open bucket into a ready dispatch unit."""
        b = self._open.pop(key)
        if not b.reqs:
            return
        if b.fallback:
            self.metrics.bump("fallback_single", len(b.reqs))
        obs.event("serve.seal",
                  cls=ServeMetrics._fmt_key(key), n=len(b.reqs))
        self._ready.append((key, b.reqs))
        self._cv.notify_all()

    # -- draining ------------------------------------------------------

    def flush(self):
        """Seal every open bucket and drain every sealed unit (new
        requests admitted DURING the drain are drained too). Safe
        from any thread; dispatches are serialized."""
        while True:
            with self._cv:
                if self._dead:
                    raise EngineKilled(
                        "engine was killed (kill_restart); restart "
                        "and replay the journal")
                self._expire_locked(time.monotonic())
                for key in list(self._open):
                    self._seal_locked(key)
                if not self._ready:
                    return
            self._drain_ready()

    def _drain_ready(self, stop_at: Optional[float] = None):
        """Dispatch sealed units with a sliding window of
        ``pipeline_depth`` in flight; collection stays in issue order
        so result scattering (and the per-bucket metrics) are
        deterministic. A mid-pipeline backend death drains cleanly:
        every issued dispatch carries its own depth-scaled watchdog
        deadline and host fallback, so collecting the window always
        terminates — zero hung futures (tests/test_runtime_faults).
        ``stop_at`` bounds a shutdown drain (units are not popped
        past it). An injected ``kill_restart`` fault aborts the drain
        like a SIGKILL: already-issued work is abandoned, futures die
        unresolved, journal entries stay unacknowledged."""
        sync = self.pipeline_depth <= 1
        pending: collections.deque = collections.deque()
        with self._dispatch_lock:
            # a fleet worker_kill (ServeEngine.kill) latches _dead
            # under this lock between drains — a dead engine must
            # never dispatch again (its queued work re-homes)
            if self._dead:
                raise EngineKilled(
                    "engine was killed; queued work stays "
                    "unacknowledged in the journal")
            while True:
                with self._cv:
                    if not self._ready:
                        break
                    # re-read the shutdown bound every iteration: a
                    # stop(timeout=...) that lands while this drain
                    # is already running must still bound it — the
                    # call-time stop_at alone would let a large
                    # backlog drain unboundedly past the contract
                    bound = stop_at
                    live = self._drain_stop_at
                    if live is not None and \
                            (bound is None or live < bound):
                        bound = live
                    if bound is not None and \
                            time.monotonic() > bound:
                        break
                    key, grp = self._ready.popleft()
                    self._nqueued -= len(grp)
                    self.metrics.queue_depth(self._nqueued)
                plan = faults.active_plan()
                if plan is not None and plan.faults_for(
                        "serve.drain", kinds=("kill_restart",)):
                    self._dead = True
                    raise EngineKilled(
                        "injected kill_restart: engine died "
                        "mid-drain (simulated SIGKILL — journal "
                        "entries stay unacknowledged)")
                # dispatch-time expiry: a unit may have aged between
                # seal and pop (the legacy drain-time deadline check)
                now = time.monotonic()
                live = []
                for r in grp:
                    if r.expired(now):
                        self.metrics.bump("deadline_missed")
                        self.admission.bump("shed_expired")
                        self.admission.note_shed("expired")
                        r.future.set_exception(DeadlineExceeded(
                            f"{r.kind} request missed its "
                            f"{r.deadline_s}s deadline in queue"))
                    else:
                        live.append(r)
                if not live:
                    continue
                state = self._dispatch_begin(key, live, sync=sync)
                if sync:
                    self._dispatch_finish(*state)
                    continue
                pending.append(state)
                if len(pending) >= self.pipeline_depth:
                    self._dispatch_finish(*pending.popleft())
            while pending:
                self._dispatch_finish(*pending.popleft())

    def _class_of(self, r):
        """(shape-class key, is_fallback). GLS requests are assembled
        here (the class must reflect the REAL problem shapes, and
        assembly has to happen before dispatch anyway); the assembled
        problem is cached on the request."""
        if isinstance(r, PhasePredictRequest):
            n, k = r.sizes
            key = phase_shape_class(n, k, self.bucket_edges)
            if key is None:
                return ("phase", pow2_ceil(n), pad_dim(k, 4)), True
            return key, False
        if isinstance(r, AppendTOAsRequest):
            # bind the engine's state store BEFORE assembly: a warm
            # append's rows must be built on the cold span's Fourier
            # frequencies (the tspan override), which only the store
            # knows
            r.bind_store(self.append_store)
            with annotate("serve.assemble"):
                pr = r.ensure_problem()
            n, p = pr.M.shape
            q = pr.F.shape[1]
            key = append_shape_class(n, p, q, self.bucket_edges)
            if key is None:
                return ("append", pow2_ceil(n), pad_dim(p),
                        pad_dim(q)), True
            return key, False
        if isinstance(r, GWBRequest):
            from pint_tpu_torch import config

            # assembly here builds the whole array likelihood (the
            # per-pulsar blocks stay lazy — they assemble as ONE
            # supervised dispatch at issue time) on the engine's
            # device; its supervisor threads through so block assembly
            # counts against this deployment's dispatch counters
            with annotate("serve.assemble"):
                lk = r.ensure_likelihood(mesh=self.mesh,
                                         axis=self.axis,
                                         supervisor=self.supervisor,
                                         device=self.device)
            return gwb_shape_class(lk.npulsars, lk.m,
                                   config.gwb_chunk()), False
        with annotate("serve.assemble"):
            pr = r.ensure_problem()
        n, p = pr.M.shape
        q = pr.F.shape[1]
        if isinstance(r, PosteriorRequest):
            from pint_tpu_torch import config

            K = config.chain_chunk_steps(r.nsteps, thin=r.thin)
            key = posterior_shape_class(n, p, q, r.nwalkers, K,
                                        r.thin, self.bucket_edges)
            if key is None:
                return ("posterior", pow2_ceil(n), pad_dim(p),
                        pad_dim(q), r.nwalkers, K, r.thin), True
            return key, False
        key = gls_shape_class(n, p, q, self.bucket_edges)
        if key is None:
            return ("gls", pow2_ceil(n), pad_dim(p), pad_dim(q)), True
        return key, False

    def _batch_pad(self, P: int) -> int:
        """Pad the batch axis to a power of two (under a mesh of m
        devices, m times a power of two) so batch sizes, like TOA
        counts, land on a bounded set of class shapes."""
        if self.mesh is not None:
            m = self.mesh.shape[self.axis]
            return m * pow2_ceil(-(-P // m))
        return pow2_ceil(P)

    def _dispatch_begin(self, key, grp: List, sync: bool = False):
        """Route one sealed unit to a capacity pool and issue its
        call (async on the supervisor's pipeline mode unless
        ``sync``). Returns the state tuple ``_dispatch_finish``
        consumes; an assembly/issue failure rides along as the
        collect slot and fails the group at finish time, so begin
        never throws into the drain loop.

        Tracing: the unit gets its own trace ("serve.unit" root
        carrying the member rids), the router verdict is a
        "serve.route" child event, and the issue half runs inside a
        "serve.issue" child span — so the supervised dispatch
        (issued here under pipelining) parents under it. Each member
        request additionally gets a retroactive "serve.queue" span
        (admission -> issue) under its OWN root, tagged with the
        unit's trace id, linking the two stories."""
        Pb = self._batch_pad(len(grp))
        full_key = key + (Pb,)
        t0 = time.monotonic()
        kind = key[0] if key[0] in ("phase", "posterior",
                                    "append", "gwb") else "gls"
        rows = self._unit_rows(key, grp, Pb)
        pool = self.router.pick(kind, rows)
        self.router.issued(pool, len(grp), rows, kind=kind)
        cls = ServeMetrics._fmt_key(key)
        usp = obs.open_root(
            "serve.unit", label="unit", kind=kind, cls=cls,
            pool=pool, n=len(grp),
            rids=[r.rid for r in grp if r.rid is not None])
        usp.event("serve.route", pool=pool, rows=rows)
        if usp.ctx is not None:
            tracer = obs.get_tracer()
            t0_trace = tracer.monotonic_us(t0)
            for r in grp:
                rosp = getattr(r, "_osp", None)
                if rosp is not None and rosp.ctx is not None and \
                        r.admitted_at is not None:
                    tracer.record_span(
                        "serve.queue",
                        tracer.monotonic_us(r.admitted_at),
                        t0_trace, parent=rosp.ctx,
                        unit=usp.trace_id)
        info: dict = {}
        try:
            with obs.span("serve.issue", parent=usp.ctx, pool=pool):
                if key[0] == "phase":
                    _, nb, kb = key
                    collect = self.cache.phase_begin(
                        full_key, grp, nb, kb, Pb, sync=sync,
                        pool=pool, info=info)
                elif key[0] == "append":
                    _, nb, pb, qb = key
                    entries = self._append_entries(grp)
                    info["append_entries"] = entries
                    collect = self.cache.append_begin(
                        full_key, grp, shape=(Pb, nb, pb, qb),
                        entries=entries, sync=sync, pool=pool,
                        info=info)
                elif key[0] == "posterior":
                    _, nb, pb, qb = key[:4]
                    collect = self.cache.posterior_begin(
                        full_key, grp, shape=(Pb, nb, pb, qb),
                        sync=sync, pool=pool, info=info,
                        progress=self._posterior_progress(grp))
                elif key[0] == "gwb":
                    collect = self.cache.gwb_begin(
                        full_key, grp, sync=sync, pool=pool,
                        info=info,
                        progress=self._gwb_progress(grp))
                else:
                    _, nb, pb, qb = key
                    collect = self.cache.gls_begin(
                        full_key, [r.problem for r in grp],
                        shape=(Pb, nb, pb, qb), sync=sync, pool=pool,
                        info=info)
        except Exception as e:
            collect = e
        return key, full_key, grp, Pb, t0, collect, pool, info, usp

    def _append_entries(self, grp: List):
        """Per-request cached state entries at issue time (None =
        cold slot, starts from the zero state). Two same-key
        requests in one unit both read the pre-batch state — the
        kernel returns additive DELTAS, so both land at commit and
        each response reflects the data up to its own rows."""
        entries = []
        for r in grp:
            e = None
            if not r.cold:
                e = self.append_store.get(r.state_key)
            entries.append(e)
        return entries

    def _append_finish(self, key, grp: List, out, info: dict):
        """Commit the append deltas to the state store and scatter
        results. A slot whose CG/basis solve failed (ok False) fails
        its future WITHOUT committing — the state stays exactly as
        before, so the caller can retry or cold-rebuild."""
        (cm_used, dSig, db, du, dscal, dparams, cov, chi2, chi2r,
         ok, iters) = out
        entries = info.get("append_entries") or [None] * len(grp)
        for k, r in enumerate(grp):
            pr = r.problem
            p = pr.M.shape[1]
            if not bool(ok[k]):
                r.future.set_exception(ValueError(
                    f"append solve for state {r.state_key!r} failed "
                    f"(singular/degenerate combined system); state "
                    f"NOT updated"))
                continue
            try:
                entry = self.append_store.commit(
                    r.state_key, pr, key[2], key[3],
                    cold=entries[k] is None, cm_used=cm_used[k],
                    dSig=dSig[k], db=db[k], du=du[k],
                    dscal=dscal[k], nrows=pr.M.shape[0])
            except Exception as e:
                r.future.set_exception(e)
                continue
            r.future.set_result(AppendResult(
                names=pr.names, dparams=dparams[k][:p],
                cov=cov[k][:p, :p], chi2=float(chi2[k]),
                chi2r=float(chi2r[k]), ntoa_total=entry.ntoa,
                cold=entries[k] is None, cg_iters=int(iters[k])))

    def _unit_rows(self, key, grp: List, Pb: int) -> int:
        """Kind-local work units one sealed unit dispatches (feeds
        the router's per-kind rate learning, so it must count the
        PADDED work the device really executes — the budget mask is a
        select, so every slot runs every chunk's K steps)."""
        if key[0] == "posterior":
            W, K = key[4], key[5]
            kmax = max((r.nsteps for r in grp), default=0)
            return Pb * W * max(1, -(-kmax // K)) * K
        if key[0] == "gwb":
            # each request sweeps its OWN chunked grid (batch slots
            # never pad: coalescing is admission-only), so the
            # executed work is the sum of per-request padded points
            K = key[3]
            return sum(max(1, -(-r.npoints // K)) * K for r in grp)
        return Pb * key[1]

    def _posterior_progress(self, grp: List):
        """Per-chunk progress hook for a posterior unit: journals a
        non-terminal progress ack per journalable request after
        every chunk dispatch, so a crash mid-chain is visible in the
        journal (the replay restarts the chain; the marks label how
        far the dead run got)."""
        if self.journal is None:
            return None
        journal = self.journal

        def progress(done_steps):
            for k, r in enumerate(grp):
                if r.rid is not None and r.payload is not None:
                    journal.progress(r.rid, int(done_steps[k]))

        return progress

    def _gwb_progress(self, grp: List):
        """Per-chunk journal progress for a GWB unit (the posterior
        convention): one non-terminal ack per journalable request
        after each of ITS sweep chunks, so a crash mid-sweep is
        visible in the journal (the replay restarts the sweep; the
        marks label how far the dead run got)."""
        if self.journal is None:
            return None
        journal = self.journal

        def progress(k, done_points):
            r = grp[k]
            if r.rid is not None and r.payload is not None:
                journal.progress(r.rid, int(done_points))

        return progress

    def _dispatch_finish(self, key, full_key, grp, Pb, t0, collect,
                         pool, info, usp):
        """Collect one issued dispatch and scatter results to the
        group's futures (the wait rides the supervisor's depth-scaled
        watchdog, so this always terminates). Feeds the router's
        rate learning with the pool that ACTUALLY served — and the
        latency histograms (queue wait / dispatch wall / e2e per
        (pool, kind, class)) with every member request."""
        kind = key[0] if key[0] in ("phase", "posterior",
                                    "append", "gwb") else "gls"
        rows = self._unit_rows(key, grp, Pb)
        try:
            if isinstance(collect, Exception):
                raise collect
            with annotate("serve.dispatch"), \
                    obs.span("serve.collect", parent=usp.ctx,
                             pool=pool):
                out = collect()
                self._observe_unit_health(kind, key, out, pool,
                                          info)
            if key[0] == "phase":
                pi, pf = out
                for k, r in enumerate(grp):
                    n = len(r.mjds)
                    r.future.set_result(PhasePredictResult(
                        phase_int=pi[k][:n], phase_frac=pf[k][:n]))
            elif key[0] == "posterior":
                chain, lnp, acc, rows_done = out
                for k, r in enumerate(grp):
                    pr = r.problem
                    p = pr.M.shape[1]
                    nrows = int(rows_done[k])
                    # OWNED copies: a view slice would pin the whole
                    # padded (Pb, S, W, pb) batch buffer for as long
                    # as any client holds its result
                    r.future.set_result(PosteriorResult(
                        names=pr.names,
                        chain=np.ascontiguousarray(
                            chain[k, :nrows, :, :p]),
                        lnprob=lnp[k, :nrows].copy(),
                        acceptance_fraction=float(acc[k])
                        / max(1, r.walker_steps),
                        nsteps=r.nsteps))
            elif key[0] == "append":
                self._append_finish(key, grp, out, info)
            elif key[0] == "gwb":
                for k, r in enumerate(grp):
                    # the driver's concatenate already owns its
                    # buffer; ascontiguousarray keeps the no-view
                    # promise if that ever changes
                    r.future.set_result(GWBResult(
                        logL=np.ascontiguousarray(out[k]),
                        log10A=r.log10A.copy(),
                        gamma=r.gamma.copy(),
                        npulsars=r.likelihood.npulsars,
                        nfreq=r.likelihood.nfreq))
            else:
                dparams, cov, chi2, chi2r = out
                for k, r in enumerate(grp):
                    pr = r.problem
                    p = pr.M.shape[1]
                    if isinstance(r, ResidualsRequest):
                        res = ResidualsResult(time_resids=pr.r,
                                              chi2=float(chi2r[k]))
                    else:
                        res = FitStepResult(
                            names=pr.names, dparams=dparams[k][:p],
                            cov=cov[k][:p, :p], chi2=float(chi2[k]),
                            chi2r=float(chi2r[k]))
                    r.future.set_result(res)
        except Exception as e:
            self.router.finished(pool, kind, rows, 0.0,
                                 used_pool="error")
            usp.end(status="failed",
                    error=f"{type(e).__name__}: {e}")
            for r in grp:
                if not r.future.done():
                    self.metrics.bump("failed")
                    r.future.set_exception(e)
            return
        done = time.monotonic()
        usp.end(status="ok",
                used_pool=info.get("used_pool", pool))
        # rate-learning wall: a pipelined collect's issue-to-collect
        # span includes time spent queued behind other in-flight
        # dispatches (up to pipeline_depth x the true service time —
        # the same corruption the supervisor excludes from RTT
        # drift). The inter-completion gap since the pool's previous
        # collect is the honest throughput sample under pipelining;
        # a collect after idle (gap would span the idle period)
        # falls back to its own issue-to-collect wall.
        last = self._pool_last_collect.get(pool)
        wall = done - t0 if last is None or last <= t0 \
            else done - last
        self._pool_last_collect[pool] = done
        self.router.finished(pool, kind, rows, wall,
                             used_pool=info.get("used_pool", pool))
        lats = [done - (r.admitted_at or t0) for r in grp]
        nb = key[1]
        rows_real = sum(self._rows_of(r) for r in grp)
        self.metrics.bucket(full_key).record(
            len(grp), Pb, rows_real, Pb * nb, lats)
        # log-bucketed latency histograms, keyed (pool, kind, class):
        # one dispatch-wall sample per unit, one queue-wait + e2e
        # sample per member request
        hkey = (info.get("used_pool", pool), kind,
                ServeMetrics._fmt_key(key))
        self.metrics.latency.record(hkey, "dispatch_wall", done - t0)
        for r in grp:
            adm = r.admitted_at or t0
            self.metrics.latency.record(hkey, "queue_wait",
                                        max(0.0, t0 - adm))
            self.metrics.latency.record(hkey, "e2e", done - adm)
        self.metrics.bump("completed", len(grp))

    @staticmethod
    def _observe_unit_health(kind, key, out, pool, info):
        """Numerical-health tap for one collected serve unit: every signal here is ALREADY in the collected outputs —
        zero extra dispatches — and the math lives in
        ``HealthMonitor.observe``, not here. A no-op
        branch when $PINT_TPU_HEALTH is unset. GUARDED: collect()
        already produced valid results when this runs, so an
        instrumentation bug must degrade to a missed observation,
        never fail the unit's futures (the supervisor's shadow hook
        makes the same promise)."""
        try:
            ServeEngine._observe_unit_health_inner(
                kind, key, out, pool, info)
        except Exception:
            pass

    @staticmethod
    def _observe_unit_health_inner(kind, key, out, pool, info):
        from pint_tpu_torch.obs import health as _health

        mon = _health.get_monitor()
        if not mon.enabled:
            return
        used = info.get("used_pool", pool)
        if kind == "posterior":
            # lnpost, not values: -inf walkers are legal (zero-
            # probability start positions), only NaN/+inf is garbage
            mon.observe("serve.posterior", {"lnpost": out[1]},
                        pool=used, key=str(key))
        elif kind == "append":
            # the append CG's effort vs the runtime budget the
            # bucket kernel ACTUALLY ran (threaded through info by
            # append_begin — never recomputed here); the worst slot
            # of the batch is the one a budget-exhaustion incident
            # cares about
            mon.observe("serve.append",
                        {"values": [out[5], out[7]],
                         "cg_iters": int(np.max(out[10])),
                         "cg_budget": info.get("append_cg_budget"),
                         "ok": bool(np.all(out[9]))},
                        pool=used, key=str(key))
        elif kind == "phase":
            mon.observe("serve.phase", {"values": list(out)},
                        pool=used, key=str(key))
        elif kind == "gwb":
            # every swept logL value: nonfinite anywhere in the grid
            # is the garbage signal (a -inf grid point would mean a
            # non-PD outer Schur system, not a low-probability one)
            mon.observe("serve.gwb",
                        {"values": [np.concatenate(
                            [np.ravel(o) for o in out])]},
                        pool=used, key=str(key))
        else:
            dparams, cov, chi2, chi2r = out
            mon.observe("serve.gls", {"values": [dparams, chi2]},
                        pool=used, key=str(key))

    @staticmethod
    def _rows_of(r) -> int:
        """KIND-LOCAL work units (must match what the router's rate
        for that kind was learned in): TOA/MJD rows for gls/phase,
        total walker-steps for a posterior chain."""
        if isinstance(r, PhasePredictRequest):
            return len(r.mjds)
        if isinstance(r, PosteriorRequest):
            return r.walker_steps
        if isinstance(r, GWBRequest):
            return r.npoints
        return r.problem.M.shape[0]

    # -- threaded serving loop ----------------------------------------

    def start(self):
        """Run the continuous-batching loop in a daemon thread.
        Futures then resolve asynchronously;
        ``ServeFuture.result(timeout)`` is the blocking wait."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pint-serve", daemon=True)
        self._thread.start()
        return self

    def kill(self):
        """Simulated SIGKILL for the fleet chaos path (worker_kill):
        latch the engine dead WITHOUT draining. Queued work is NOT
        failed — futures stay unresolved exactly as a real process
        death leaves them, journal entries stay unacknowledged, and
        the fleet front re-homes them onto a survivor (the original
        caller's future is then resolved with the survivor's
        bit-identical result). The shared journal is deliberately
        NOT closed and no state snapshot is written: both belong to
        the fleet, not the corpse. Blocks at most one in-flight
        drain unit (the kill lands at the next drain boundary, like
        the injected kill_restart fault)."""
        self._stop.set()
        with self._dispatch_lock:
            self._dead = True
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            self._thread = None

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None):
        """Stop the loop. ``drain=True`` (default) keeps dispatching
        what is queued so no accepted request is silently dropped;
        ``timeout`` bounds that drain — work still queued at the
        deadline is shed with an explicit ``ShutdownShed`` per
        request (the graceful-shutdown contract: labeled, never
        silent, never unbounded). Writes the serve-state snapshot
        and closes the journal."""
        stop_at = None if timeout is None \
            else time.monotonic() + max(0.0, timeout)
        # the loop's own final drain (it seals + drains on stop)
        # must honor the same bound, or it drains unboundedly before
        # this thread ever reaches the shed step
        self._drain_stop_at = stop_at
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            self._thread = None
        try:
            if drain and not self._dead:
                if stop_at is None:
                    self.flush()
                else:
                    while time.monotonic() <= stop_at:
                        with self._cv:
                            for key in list(self._open):
                                self._seal_locked(key)
                            if not self._ready:
                                break
                        self._drain_ready(stop_at=stop_at)
                    self._shed_remaining()
        finally:
            self._persist_state("shutdown")

    def _shed_remaining(self):
        """Fail everything still queued after a bounded shutdown
        drain — each future gets a labeled ShutdownShed (the daemon
        turns these into explicit shed response lines)."""
        with self._cv:
            reqs = list(self._queued_requests_locked())
            self._open.clear()
            self._ready.clear()
            self._nqueued = 0
            self.metrics.queue_depth(0)
        if reqs:
            # shutdown-drain flight dump: the bounded
            # drain expired with work still queued — the post-mortem
            # pairing of the journal's unserved set with what the
            # engine was doing when the clock ran out
            obs.flight_dump("shutdown_shed", shed=len(reqs),
                            admission=self.admission.snapshot())
        for r in reqs:
            self.admission.bump("shed_shutdown")
            if not r.future.done():
                r.future.set_exception(ShutdownShed(
                    f"{r.kind} request shed: engine shut down "
                    f"before it dispatched (bounded drain timeout)"))

    def _persist_state(self, reason: str):
        if self.cache.aot is not None:
            from pint_tpu_torch.serve.journal import save_state

            try:
                save_state(self.cache.aot.dir,
                           self.metrics.snapshot(), reason=reason)
            except Exception:
                pass
        if self.journal is not None and self._journal_owned:
            self.journal.close()

    def _loop(self):
        while True:
            with self._cv:
                while not self._open and not self._ready and \
                        not self._stop.is_set():
                    self._cv.wait(timeout=0.25)
                if self._stop.is_set():
                    stop_at = self._drain_stop_at
                    if (not self._open and not self._ready) or \
                            (stop_at is not None
                             and time.monotonic() > stop_at):
                        # drained clean, or the bounded shutdown
                        # window is spent — stop() owns the labeled
                        # shed of whatever remains; spinning here
                        # would just burn the join timeout
                        return
            # continuous batching: hold open buckets for their
            # coalescing window (a full bucket seals itself at
            # admission), then seal and dispatch — new requests keep
            # being admitted into fresh open buckets while sealed
            # units are in flight
            while not self._stop.is_set():
                with self._cv:
                    self._expire_locked(time.monotonic())
                    if self._ready:
                        break
                    if not self._open:
                        break
                    now = time.monotonic()
                    due = [key for key, b in self._open.items()
                           if now >= b.opened_at + self.window_s]
                    if due:
                        for key in due:
                            self._seal_locked(key)
                        break
                time.sleep(min(1e-3, max(self.window_s, 1e-4)))
            if self._stop.is_set():
                with self._cv:
                    for key in list(self._open):
                        self._seal_locked(key)
            try:
                self._drain_ready(stop_at=self._drain_stop_at)
            except EngineKilled:
                return
            except BaseException as e:
                # unhandled engine exception: dump the black box
                # before the drain thread dies — the one trigger
                # where the trace is ALL the evidence there will be
                obs.flight_dump("engine_exception",
                                error=f"{type(e).__name__}: {e}")
                raise


class ServeGLSFitter(Fitter):
    """Iterated-GLS fitter routed through a ServeEngine — the
    ``Fitter.auto(serve=engine)`` path. Each iteration submits one
    FitStepRequest and applies the returned correction, exactly the
    ``fit_pta`` update loop but with the solve coalesced against
    whatever else the engine is serving. The final chi2 is the
    bases-marginalized chi2 at the fitted point (``Residuals.chi2``
    semantics)."""

    def __init__(self, toas, model, engine: ServeEngine,
                 residuals=None, track_mode=None):
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.engine = engine

    def fit_toas(self, maxiter: int = 4,
                 timeout: Optional[float] = None):
        from pint_tpu_torch.residuals import Residuals

        t0 = time.perf_counter()
        res = None
        for _ in range(max(1, maxiter)):
            fut = self.engine.submit(FitStepRequest(
                self.toas, self.model, track_mode=self.track_mode))
            res = fut.result(timeout=timeout)
            self.update_model(np.asarray(res.dparams), res.names)
        # one more pass at the fitted point: uncertainties + chi2
        fut = self.engine.submit(FitStepRequest(
            self.toas, self.model, track_mode=self.track_mode))
        res = fut.result(timeout=timeout)
        self.set_uncertainties(np.asarray(res.cov), res.names)
        self.resids = Residuals(self.toas, self.model,
                                track_mode=self.track_mode)
        self.converged = True
        chi2 = res.chi2r
        self._record_stats(chi2, max(1, maxiter) + 1, t0)
        return chi2
