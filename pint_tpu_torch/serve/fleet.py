"""Serve fleet: journal-replicated multi-worker failover (a port of
pint_tpu/serve/fleet.py; host code, copied).

One ``ServeEngine`` is one worker: one admission queue, one dispatch
serializer, one supervisor. A deployment that loses that process
loses every queued request until a restart replays the journal. This
module turns the journal into the fleet's REPLICATED LOG and makes
worker death a first-class serving event with a bounded blast
radius — lose a worker, lose 1/N of in-flight capacity and ZERO
accepted requests:

- ``WorkerLease``: each worker registers in the shared journal with a
  ``lease`` record and renews it with periodic ``heartbeat`` records
  (``$PINT_TPU_FLEET_HEARTBEAT_S``). Liveness is a JOURNAL fact, not
  an in-memory one — a worker partitioned from the journal looks
  exactly like a dead one, which is the only safe reading.
- ``FleetFront``: N workers over ONE journal and ONE AOT store.
  Submits round-robin across live workers; every journaled admit
  carries its owner (``worker=``). The front's expiry sweep compares
  each live worker's newest heartbeat against the lease TTL
  (``$PINT_TPU_FLEET_LEASE_TTL_S``); a missed lease FENCES the worker
  (``ServeEngine.kill`` — a fenced engine can never dispatch again,
  so the split-brain worker whose beats stopped reaching the journal
  cannot double-serve) and re-homes its unacknowledged admits onto a
  survivor: ``rehome`` records move ownership in the log, the
  survivor replays them through the normal replay path (bit-identical
  results — same kernels, same shape classes), and each survivor
  future's result is copied into the ORIGINAL caller's future, so
  every submitted request still resolves to exactly one
  ``serve.terminal``. Chunked kinds (posterior/GWB/append) re-home at
  their journaled chunk boundary exactly like a restart replay.
- Warm-store reuse: workers share one ``$PINT_TPU_AOT_DIR``, so a
  re-homed shape class that any worker ever recorded is primed on the
  survivor at construction (tests/test_torch_serve_restart.py).

Failure-injection kinds (``runtime.faults``): ``worker_kill`` at key
``fleet.worker/<id>`` kills that worker mid-burst; ``lease_expire``
at key ``fleet.lease/<id>`` forces that worker's lease to read as
expired at the next sweep without killing the engine first — the
fence in the sweep is what keeps the transfer safe.

Scope note (honest naming): ``FleetFront`` runs its N workers
in-process — the demo/bench/chaos surface. True cross-process fleets
run one ``pint_serve --worker-id`` per process over the same
``$PINT_TPU_JOURNAL``; the journal protocol (lease / heartbeat /
admit-with-owner / rehome) is identical, the front is then whatever
spawned the workers. Only requests WITH a journal payload get the
re-home guarantee: an in-memory-only request cannot be rebuilt on a
survivor (same contract as restart replay).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from pint_tpu_torch import obs
from pint_tpu_torch.runtime import faults, locks
from pint_tpu_torch.serve.request import EngineKilled
from pint_tpu_torch.serve.scheduler import ServeEngine

__all__ = ["WorkerLease", "FleetWorker", "FleetFront"]


class WorkerLease:
    """One worker's liveness in the shared journal: a ``lease``
    record at construction, ``heartbeat`` records on every
    ``beat()``. ``start()`` runs beats on a daemon thread at the
    configured cadence; tests drive ``beat()`` manually for
    determinism."""

    def __init__(self, journal, worker_id: str,
                 heartbeat_s: Optional[float] = None):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        self.journal = journal
        self.worker_id = worker_id
        self.heartbeat_s = config.fleet_heartbeat_s() \
            if heartbeat_s is None else float(heartbeat_s)
        self._c_beats = om.counter(
            "pint_tpu_fleet_heartbeats_total",
            "fleet worker lease heartbeats written"
        ).child(scope=om.new_scope("fleet"), worker=worker_id)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.journal.lease(worker_id)
        self._c_beats.inc()  # the lease record is the first beat

    def beat(self):
        self.journal.heartbeat(self.worker_id)
        self._c_beats.inc()

    def start(self):
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.wait(self.heartbeat_s):
                self.beat()

        self._thread = threading.Thread(
            target=_loop, name=f"pint-lease-{self.worker_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None


class FleetWorker:
    """One fleet member: a ``ServeEngine`` plus its journal lease."""

    def __init__(self, worker_id: str, engine: ServeEngine,
                 lease: WorkerLease):
        self.worker_id = worker_id
        self.engine = engine
        self.lease = lease


def _copy_result(src_fut, dst_fut):
    """Resolve the original caller's future with the survivor's
    replayed result (or exception). Guarded: the original may have
    resolved already (a kill that raced an in-flight collect)."""

    def _done(f):
        if dst_fut.done():
            return
        e = f.exception()
        try:
            if e is not None:
                dst_fut.set_exception(e)
            else:
                dst_fut.set_result(f.result())
        except Exception:
            pass  # lost the resolve race — the earlier result stands

    src_fut.add_done_callback(_done)


class _FleetMetricsView:
    """Duck-typed ``ServeMetrics`` facade over the fleet — what the
    pint_serve stats path (``metrics.snapshot()``), the session
    snapshot, and the restart bookkeeping (``restart_info``) call,
    so ``--fleet`` drops into the daemon without a second code path.
    The top-level snapshot is the FIRST worker's (the stable key
    set every consumer expects) with fleet-wide totals overriding
    the throughput counters and per-worker detail alongside."""

    def __init__(self, front: "FleetFront"):
        self._front = front

    @property
    def restart_info(self):
        w = next(iter(self._front.workers.values()))
        return w.engine.metrics.restart_info

    def snapshot(self) -> dict:
        front = self._front
        per = {wid: w.engine.metrics.snapshot()
               for wid, w in front.workers.items()}
        snap = dict(next(iter(per.values())))
        for key in ("submitted", "completed", "queue_depth"):
            vals = [p.get(key) for p in per.values()
                    if p.get(key) is not None]
            if vals:
                snap[key] = sum(vals)
        snap["fleet"] = front.snapshot()
        snap["workers"] = per
        return snap

    def report(self) -> str:
        return "\n".join(
            f"[{wid}] {w.engine.metrics.report()}"
            for wid, w in self._front.workers.items())


class FleetFront:
    """N workers, one journal, one admission front.

    ``factory(payload)`` is the replay factory re-homing rebuilds
    requests with (same contract as ``ServeEngine.replay``).
    ``journal`` is the shared replicated log — a path (the front
    constructs and owns the ``RequestJournal``) or a prebuilt one.
    Workers run THREADED (``ServeEngine.start``): a synchronous
    future pumping a dead worker's queue would raise instead of
    waiting out a re-home.
    """

    # registry counter names (mutated via .inc() only)
    _COUNTERS = ("rehomed", "lease_expiries", "worker_kills")

    def __init__(self, factory: Callable[[dict], object],
                 n: Optional[int] = None,
                 journal=None,
                 aot_dir: Optional[str] = None,
                 lease_ttl_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 start: bool = True,
                 engine_kwargs: Optional[dict] = None,
                 pools: Optional[Tuple[str, ...]] = None):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        if journal is None:
            journal = config.journal_path()
        if journal is None:
            raise ValueError(
                "FleetFront needs a journal (path or RequestJournal) "
                "— the shared journal IS the fleet's replicated log")
        self._journal_owned = isinstance(journal, str)
        if isinstance(journal, str):
            from pint_tpu_torch.serve.journal import RequestJournal

            journal = RequestJournal(journal)
        self.journal = journal
        self.factory = factory
        self.lease_ttl_s = config.fleet_lease_ttl_s() \
            if lease_ttl_s is None else float(lease_ttl_s)
        n = config.fleet_workers() if n is None else max(1, int(n))
        self._scope = om.new_scope("fleet")
        self._c = {
            name: om.counter(
                f"pint_tpu_fleet_{name}_total",
                f"fleet {name.replace('_', ' ')}"
            ).child(scope=self._scope)
            for name in self._COUNTERS}
        # fleet bookkeeping lock: a LEAF lock (never engine-marked —
        # submits must not fsync/dispatch under it; pick/track take
        # it briefly, the actual engine submit runs outside)
        self._lock = locks.make_lock("serve.fleet")
        self._rr = 0
        self._state: Dict[str, str] = {}    # live | dead | rehomed
        self._inflight: Dict[str, object] = {}  # rid -> original req
        self.workers: Dict[str, FleetWorker] = {}
        kw = dict(engine_kwargs or {})
        kw.setdefault("aot_dir", aot_dir)
        for i in range(n):
            wid = f"w{i}"
            eng = ServeEngine(journal=self.journal, worker_id=wid,
                              pools=pools, **kw)
            lease = WorkerLease(self.journal, wid,
                                heartbeat_s=heartbeat_s)
            self.workers[wid] = FleetWorker(wid, eng, lease)
            self._state[wid] = "live"
        self._sweep_stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        self.metrics = _FleetMetricsView(self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self, sweep_s: Optional[float] = None):
        """Start every worker loop + lease heartbeat and the expiry
        sweeper (cadence defaults to half the heartbeat interval, so
        an expiry is noticed within ~TTL + heartbeat/2)."""
        for w in self.workers.values():
            w.engine.start()
            w.lease.start()
        if self._sweeper is None:
            if sweep_s is None:
                sweep_s = min(w.lease.heartbeat_s
                              for w in self.workers.values()) / 2.0
            self._sweep_stop.clear()

            def _loop():
                while not self._sweep_stop.wait(sweep_s):
                    try:
                        self.sweep()
                    except Exception:
                        pass  # the sweeper must outlive a bad sweep

            self._sweeper = threading.Thread(
                target=_loop, name="pint-fleet-sweep", daemon=True)
            self._sweeper.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None):
        """Stop the sweeper, leases, then every LIVE worker (bounded
        drain semantics per ``ServeEngine.stop``); close the journal
        if the front constructed it."""
        self._sweep_stop.set()
        t = self._sweeper
        if t is not None:
            t.join(timeout=10.0)
            self._sweeper = None
        for w in self.workers.values():
            w.lease.stop()
        for wid, w in self.workers.items():
            if self._state.get(wid) == "live":
                try:
                    w.engine.stop(drain=drain, timeout=timeout)
                except Exception:
                    pass
        if self._journal_owned:
            self.journal.close()

    # -- submission ----------------------------------------------------

    def _live_locked(self) -> List[str]:
        return [wid for wid, st in self._state.items()
                if st == "live"]

    def _pick_live(self) -> Optional[FleetWorker]:
        with self._lock:
            live = self._live_locked()
            if not live:
                return None
            wid = live[self._rr % len(live)]
            self._rr += 1
            return self.workers[wid]

    def _track(self, req):
        rid = getattr(req, "rid", None)
        if rid is None or getattr(req, "payload", None) is None:
            return  # unjournalable: no re-home guarantee

        with self._lock:
            self._inflight[rid] = req

        def _done(_f, rid=rid):
            with self._lock:
                self._inflight.pop(rid, None)

        req.future.add_done_callback(_done)

    def _poll_faults(self):
        plan = faults.active_plan()
        if plan is None:
            return
        with self._lock:
            live = self._live_locked()
        for wid in live:
            if plan.faults_for(f"fleet.worker/{wid}",
                               kinds=("worker_kill",)):
                self.kill_worker(wid)

    def submit(self, req):
        """Admit one request through a live worker. A worker that
        died between pick and submit is fenced and the next live one
        tried; with zero live workers the fleet is down and the
        submit raises ``EngineKilled`` (the caller's restart/retry
        signal, same as the single-engine contract)."""
        self._poll_faults()
        for _ in range(max(1, len(self.workers))):
            w = self._pick_live()
            if w is None:
                break
            try:
                fut = w.engine.submit(req)
            except EngineKilled:
                self._fence(w.worker_id, reason="submit_raced_kill")
                continue
            self._track(req)
            return fut
        raise EngineKilled("no live workers in the fleet")

    # -- failure handling ----------------------------------------------

    def _fence(self, wid: str, reason: str = "lease_expired"):
        """live -> dead: stop the lease, kill the engine (it can
        never dispatch again), leave its journal entries for the
        re-home pass. Idempotent."""
        with self._lock:
            if self._state.get(wid) != "live":
                return
            self._state[wid] = "dead"
        w = self.workers[wid]
        w.lease.stop()
        try:
            w.engine.kill()
        except Exception:
            pass
        obs.flight_dump(f"fleet_fence:{wid}", worker=wid,
                        fence_reason=reason)

    def kill_worker(self, wid: str):
        """The worker_kill fault (simulated worker SIGKILL): fence
        immediately — its heartbeats stop with it, and the normal
        sweep re-homes its unacked admits."""
        with self._lock:
            was_live = self._state.get(wid) == "live"
        if not was_live:
            return
        self._c["worker_kills"].inc()
        self._fence(wid, reason="worker_kill")

    def sweep(self, now: Optional[float] = None):
        """The liveness sweep: fence any live worker whose newest
        journal heartbeat is older than the lease TTL (or whose
        lease an injected ``lease_expire`` fault forces to read
        expired), then re-home every dead worker's unacknowledged
        admits onto a survivor. Returns the number of requests
        re-homed this pass. Safe to call from any thread; re-homing
        is serialized by worker state (dead -> rehomed exactly
        once)."""
        self._poll_faults()
        plan = faults.active_plan()
        beats = self.journal.workers()
        if now is None:
            now = time.time()
        with self._lock:
            live = self._live_locked()
        for wid in live:
            forced = plan is not None and plan.faults_for(
                f"fleet.lease/{wid}", kinds=("lease_expire",))
            stale = (now - beats.get(wid, 0.0)) > self.lease_ttl_s
            if forced or stale:
                self._c["lease_expiries"].inc()
                self._fence(wid, reason="lease_expire"
                            if forced else "heartbeat_stale")
        return self._rehome_dead()

    def _rehome_dead(self) -> int:
        moved = 0
        with self._lock:
            dead = [wid for wid, st in self._state.items()
                    if st == "dead"]
        for wid in dead:
            moved += self._rehome_one(wid)
        return moved

    def _rehome_one(self, wid: str) -> int:
        recs = self.journal.unacknowledged(owner=wid)
        survivor = self._pick_live()
        if survivor is None:
            return 0  # fleet-wide outage: stays dead, retried later
        with self._lock:
            if self._state.get(wid) != "dead":
                return 0
            self._state[wid] = "rehomed"
        try:
            with obs.span("fleet.rehome", worker=wid,
                          survivor=survivor.worker_id, n=len(recs)):
                for rec in recs:
                    self.journal.rehome(rec["rid"],
                                        survivor.worker_id)
                futs = survivor.engine.replay(self.factory,
                                              records=recs)
        except EngineKilled:
            # the survivor died under us: revert for the next sweep
            self._fence(survivor.worker_id,
                        reason="rehome_target_died")
            with self._lock:
                self._state[wid] = "dead"
            return 0
        for rec, fut in zip(recs, futs):
            with self._lock:
                orig = self._inflight.get(rec["rid"])
            if orig is not None and orig.future is not fut:
                # never pump the corpse: the original future must
                # wait for the survivor, not flush the dead engine
                orig.future._sync_engine = None
                _copy_result(fut, orig.future)
        self._c["rehomed"].inc(len(recs))
        return len(recs)

    # -- introspection -------------------------------------------------

    def live_workers(self) -> List[str]:
        with self._lock:
            return self._live_locked()

    def health_blocks(self) -> Dict[str, dict]:
        """Per-worker router pools block for /healthz — breaker
        state, learned EWMA rate, in-flight depth per capacity pool.
        Router leaf-lock reads only, NEVER an engine lock (the
        scrape-isolation contract)."""
        return {wid: w.engine.router.health_block()
                for wid, w in self.workers.items()}

    def snapshot(self) -> dict:
        with self._lock:
            states = dict(self._state)
            inflight = len(self._inflight)
        out = {
            "workers": states,
            "live": [w for w, s in states.items() if s == "live"],
            "inflight_tracked": inflight,
            "lease_ttl_s": self.lease_ttl_s,
            "journal": self.journal.counts(),
            "counters": {name: int(c.value())
                         for name, c in self._c.items()},
        }
        out["engines"] = {
            wid: {"dead": bool(w.engine._dead),
                  "pools": w.engine.router.health_block()}
            for wid, w in self.workers.items()}
        return out
