"""Offline serving daemon: JSONL requests on stdin -> coalesced
batched dispatches -> JSONL results on stdout (a port of
pint_tpu/scripts/pint_serve.py; the engine runs on ``--device``, the GPU
by default: ``python -m pint_tpu_torch.scripts.pint_serve --device
cpu`` serves on the CPU).

The demo surface of ``pint_tpu_torch.serve``: each input line is one
request; the threaded ServeEngine coalesces whatever arrives within
the window into padded batched dispatches. Request forms:

    {"kind": "fit_step",  "par": P, "tim": T, "id": ..., "deadline_ms": ...,
     "tenant": ...}
    {"kind": "residuals", "par": P, "tim": T, ...}
    {"kind": "phase", "par": P, "mjds": [...], "obs": "@",
     "seg_min": 60.0, ...}
    {"kind": "posterior", "par": P, "tim": T, "nwalkers": 32,
     "nsteps": 500, "seed": 0, "thin": 1, ...}
    {"kind": "stats", "id": ...}
    {"kind": "profile", "seconds": N, "id": ...}

(par, tim) pairs are loaded once and cached — repeated requests
against the same pulsar are the serving-state hot path, paying only
the batched solve. Phase requests generate (and cache) polycos
covering the requested MJDs, then split the MJDs per segment into
PhasePredictRequests. ``--demo N`` synthesizes an N-request
mixed-shape workload instead of reading stdin.

Lifecycle:

- **graceful shutdown**: SIGTERM/SIGINT stops the stdin read, drains
  the engine with a bounded timeout (``--drain-timeout-s`` /
  ``$PINT_TPU_SERVE_DRAIN_TIMEOUT_S``), and every request still
  queued at the bound gets an explicit
  ``{"status": "shed", "reason": "shutdown"}`` result line — queued
  work is never silently dropped on the floor;
- **crash-safe journal** (``--journal`` / ``$PINT_TPU_JOURNAL``):
  each input record is journaled at admission and acknowledged when
  its last result line is emitted (graceful sheds ack terminally as
  ``shed:shutdown`` — the client was told). On startup,
  unacknowledged records from a previous crash are REPLAYED before
  stdin is read;
- **warm restart** (``--aot-dir`` / ``$PINT_TPU_AOT_DIR``): the engine
  records each shape class it served and a restarted daemon primes
  them on the card before its first request.

Observability: a ``{"kind": "stats"}`` line answers
IMMEDIATELY on the reader thread with the latency-histogram
quantiles, flight-recorder status and dispatch counters — it is
never journaled, never queued, and never perturbs in-flight
batches. ``--trace-jsonl PATH`` (or ``$PINT_TPU_TRACE_STREAM``)
streams every completed span as a JSONL line; ``$PINT_TPU_TRACE``
arms the ring tracer; ``$PINT_TPU_FLIGHT_DIR`` arms the flight
recorder, which also dumps on the SIGTERM bounded-drain path.

Metrics plane: ``--metrics-port N`` (or
``$PINT_TPU_METRICS_PORT``; 0 = ephemeral, announced as a
``{"event": "metrics_server", "port": ...}`` line) serves Prometheus
text exposition on ``/metrics`` and breaker/pool health JSON on
``/healthz`` from a stdlib daemon thread that NEVER takes the engine
lock — the pull surface a multi-worker fleet scrapes per worker. The
``stats`` answer carries a ``registry`` summary of the same metric
plane; ``$PINT_TPU_SLO`` arms the burn-rate watchdog (fires the
flight recorder with reason ``slo_burn:<name>``).

Numerical health: with ``$PINT_TPU_HEALTH`` (and/or
``$PINT_TPU_SHADOW_RATE``) armed, the ``stats`` answer and the serve
snapshot gain a ``health`` verdict block (worst recent verdict per
(pool, kind), last incident reason + age) and ``/healthz`` a
``numerics`` block that degrades the response to 503 on an
unresolved bad verdict — all monitor-lock reads, still never an
engine lock, still never journaled.

One JSON result line per request (input order NOT guaranteed — lines
carry the request id); the final line is the engine metrics snapshot
({"metric": "serve_session", ...}) whose ``admission``/``router``/
``restart`` blocks label every shed, reroute and replay.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading

from pint_tpu_torch.runtime import locks
import uuid

__all__ = ["main"]


class _Shutdown(Exception):
    """Raised into the main thread by the SIGTERM/SIGINT handler to
    break the blocking stdin read."""


def _install_signal_handlers():
    """Route SIGTERM/SIGINT into the graceful-shutdown path. Returns
    the previous handlers so an embedding process (or a test driving
    main() directly) can restore them."""
    def handler(signum, frame):
        raise _Shutdown(signal.Signals(signum).name)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):
            pass  # not the main thread (tests drive main() directly)
    return prev


def _restore_signal_handlers(prev):
    for sig, h in (prev or {}).items():
        try:
            signal.signal(sig, h)
        except (ValueError, OSError):
            pass


def _ignore_signals():
    """Once the graceful shutdown has begun, further SIGTERM/SIGINT
    must not abort the bounded drain mid-way — the shed lines and
    the final session snapshot are the shutdown contract."""
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, signal.SIG_IGN)
        except (ValueError, OSError):
            pass


def _shed_pending_stdin(stream=None) -> int:
    """Shed input lines already written when shutdown arrives DURING
    STARTUP (no engine yet): each pending JSONL record gets the same
    explicit ``{"status": "shed", "reason": "shutdown"}`` line the
    bounded drain emits — an early signal must not silently drop a
    client's work either. Bounded by construction: only what is
    already buffered on the pipe is drained (select with a 50 ms
    grace per read, EOF stops)."""
    import select

    shed = 0

    def shed_line(line):
        nonlocal shed
        line = line.strip()
        if not line or line.startswith("#"):
            return
        try:
            rid = json.loads(line).get("id")
        except Exception:
            rid = None
        obj = {"status": "shed", "reason": "shutdown"}
        if rid is not None:
            obj["id"] = rid
        print(json.dumps(obj), flush=True)
        shed += 1

    if stream is not None:          # tests drive main(stdin=[...])
        for line in stream:
            shed_line(line)
        return shed
    try:
        while select.select([sys.stdin], [], [], 0.05)[0]:
            line = sys.stdin.readline()
            if not line:
                break
            shed_line(line)
    except (OSError, ValueError):
        pass                        # stdin closed / not selectable
    return shed


class _LineAck:
    """Journal acknowledgement for ONE input record: a record may fan
    out into several engine requests (phase segments); the terminal
    ack is written when the LAST of them has emitted its result
    line. Thread-safe — emissions arrive from the drain thread while
    the expected count is still being established on the reader
    thread."""

    def __init__(self, journal, rid):
        self.journal = journal
        self.rid = rid
        self._lock = locks.make_lock("serve.cli_state")
        self._expected = None
        self._emitted = 0
        self._acked = False
        self._worst = "served"

    def emitted(self, status: str = "served"):
        with self._lock:
            self._emitted += 1
            if status != "served":
                self._worst = status
            self._maybe_ack()

    def expect(self, n: int):
        with self._lock:
            self._expected = n
            self._maybe_ack()

    def _maybe_ack(self):
        if self._acked or self.journal is None:
            return
        if self._expected is not None and \
                self._emitted >= self._expected:
            self._acked = True
            # zero submissions = nothing was served (the error went
            # through the uncounted report path): terminal "failed",
            # never a fabricated "served"
            self.journal.ack(self.rid, self._worst
                             if self._expected > 0 else "failed")

    def fail(self):
        """Terminal "failed" ack for a record whose submission path
        raised — without this a journaled record that can never
        submit (a deleted par file, say) would be REPLAYED on every
        restart forever."""
        with self._lock:
            if self._acked or self.journal is None:
                return
            self._acked = True
            self.journal.ack(self.rid, "failed")


def _load_pair(cache, par, tim):
    """(model, toas) of a par/tim pair, loaded once per daemon on the
    cache's device (``cache["device"]``; None = "cuda")."""
    key = ("pair", par, tim)
    if key not in cache:
        import warnings

        from pint_tpu_torch.models import get_model_and_toas

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cache[key] = get_model_and_toas(
                par, tim, device=cache.get("device"))
    return cache[key]


def _polycos_for(cache, par, obs, mjd_lo, mjd_hi, seg_min):
    key = ("polyco", par, obs, round(mjd_lo, 6), round(mjd_hi, 6),
           seg_min)
    if key not in cache:
        import warnings

        from pint_tpu_torch.models import get_model
        from pint_tpu_torch.polycos import Polycos

        dev = cache.get("device")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = get_model(par, device=dev)
            cache[key] = Polycos.generate_polycos(
                model, mjd_lo, mjd_hi, obs, seg_length_min=seg_min,
                device=dev)
    return cache[key]


def _posterior_request(cache, rec, deadline_s, tenant,
                       payload=None):
    """Build one quantized PosteriorRequest from a line record —
    shared by the submit path and the fleet replay factory (the
    quantization below must be identical in both or a re-homed chain
    lands in a different shape class than the original)."""
    from pint_tpu_torch.parallel.pta import build_problem
    from pint_tpu_torch.serve import PosteriorRequest
    from pint_tpu_torch.serve.bucket import pow2_ceil

    model, toas = _load_pair(cache, rec["par"], rec["tim"])
    from pint_tpu_torch.serve.request import _DESIGN_LOCK

    with _DESIGN_LOCK:
        problem = build_problem(toas, model)
    # client-facing quantization: nwalkers/thin ride EXACTLY in
    # the posterior class key (they fix the chain program), so
    # arbitrary client values would mean one class per distinct
    # request shape. Pow2-quantize both (more walkers is strictly
    # better sampling; nsteps rounds up to stay a thin multiple) so
    # classes stay bounded by class count, not traffic. The
    # walker FLOOR comes from the problem's real dimension count
    # (the 2*ndim ensemble guard), so a default request never
    # hard-fails on a wide model; nsteps is capped so one
    # request cannot monopolize a pool with an unbounded
    # sequential chunk loop.
    p = problem.M.shape[1]
    W = max(int(rec.get("nwalkers", 32)), 2 * p + 2)
    W = min(1024, max(8, pow2_ceil(W)))
    thin = min(16, max(1, pow2_ceil(int(rec.get("thin", 1)))))
    nsteps = min(int(rec.get("nsteps", 500)), 1_000_000)
    nsteps = ((nsteps + thin - 1) // thin) * thin
    return PosteriorRequest(
        problem=problem, nwalkers=W, nsteps=nsteps,
        seed=int(rec.get("seed", 0)), thin=thin,
        deadline_s=deadline_s, tenant=tenant, payload=payload)


def _line_factory(cache):
    """Fleet replay factory: rebuild a single-submission
    request from its journaled line record. Re-homing resolves the
    ORIGINAL caller's future with the rebuilt request's result, so
    the daemon's emission callback stays wired to the original."""

    def factory(payload):
        from pint_tpu_torch.serve import FitStepRequest, ResidualsRequest

        kind = payload.get("kind", "fit_step")
        deadline_s = payload["deadline_ms"] / 1e3 \
            if payload.get("deadline_ms") is not None else None
        tenant = payload.get("tenant")
        if kind in ("fit_step", "residuals"):
            model, toas = _load_pair(cache, payload["par"],
                                     payload["tim"])
            cls = FitStepRequest if kind == "fit_step" \
                else ResidualsRequest
            return cls(toas, model, deadline_s=deadline_s,
                       tenant=tenant, payload=payload)
        if kind == "posterior":
            return _posterior_request(cache, payload, deadline_s,
                                      tenant, payload=payload)
        raise ValueError(f"kind {kind!r} is not fleet-replayable")

    return factory


def _submit_line(engine, cache, rec, emit, report, ack=None,
                 journal_payload=False):
    """Parse one request record and submit it; wire result emission
    through the future's done-callback so the daemon never blocks on
    a single request. Returns the number of requests actually
    submitted (= the number of ``emit`` calls this line will
    eventually produce — the pending-semaphore contract); failures
    that submit NOTHING go through ``report`` (uncounted).

    ``journal_payload=True`` (fleet mode) attaches the line record
    as the request payload for single-submission kinds, so the
    WORKER engine journals it with an owner and a lost worker's
    requests re-home; phase fan-outs stay unjournaled (several
    requests per line — a line-level replay covers them instead)."""
    import numpy as np

    from pint_tpu_torch.serve import (
        FitStepRequest,
        PhasePredictRequest,
        ResidualsRequest,
        ShutdownShed,
    )

    rid = rec.get("id")
    kind = rec.get("kind", "fit_step")
    if kind == "stats":
        # introspection read: answered inline from host bookkeeping
        # (histogram snapshots + flight status + dispatch counters)
        # — zero engine submissions, zero journal lines, in-flight
        # batches untouched
        from pint_tpu_torch.obs import metrics as om

        snap = engine.metrics.snapshot()
        out = {"ok": True, "kind": "stats",
               "latency": snap.get("latency", {}),
               "obs": snap.get("obs"),
               "dispatch": snap.get("dispatch"),
               "admission": snap.get("admission"),
               "queue_depth": snap.get("queue_depth"),
               "completed": snap.get("completed"),
               "submitted": snap.get("submitted"),
               # the same answer as a registry view — the
               # inline twin of a /metrics scrape
               "registry": om.get_registry().snapshot()}
        if snap.get("slo") is not None:
            out["slo"] = snap["slo"]
        # the numerical-health verdict block (worst recent
        # verdict per (pool, kind), last incident + age) — still
        # engine-lock-free (snapshot reads monitor-lock state only),
        # still never journaled (this whole branch is the inline
        # introspection path)
        if snap.get("health") is not None:
            out["health"] = snap["health"]
        if rid is not None:
            out["id"] = rid
        report(out)
        if ack is not None:
            # a stats record replayed out of a legacy journal must
            # ack terminally (zero submissions -> "failed"), never
            # replay forever
            ack.expect(0)
        return 0
    if kind == "profile":
        # open one bounded profiler window capturing the
        # NEXT dispatches ({"kind": "profile", "seconds": N}) —
        # answered inline like stats (zero engine submissions, never
        # journaled, in-flight batches untouched); disarmed
        # ($PINT_TPU_PROFILE_DIR unset) or rate-limited requests get
        # a labeled refusal, never an error path
        from pint_tpu_torch.obs import perf as _perf

        res = _perf.request_window(rec.get("seconds"),
                                   reason="profile")
        out = {"kind": "profile"}
        out.update(res)
        if rid is not None:
            out["id"] = rid
        report(out)
        if ack is not None:
            ack.expect(0)
        return 0
    tenant = rec.get("tenant")
    deadline_s = rec["deadline_ms"] / 1e3 \
        if rec.get("deadline_ms") is not None else None

    def finish(kind):
        def cb(fut):
            out = {"id": rid, "kind": kind}
            try:
                res = fut.result(timeout=0)
            except ShutdownShed:
                # the graceful-shutdown contract: an explicit shed
                # line per unserved request, never a silent drop
                out.update(ok=False, status="shed",
                           reason="shutdown")
                emit(out, status="shed:shutdown")
                return
            except Exception as e:
                out.update(ok=False, error=f"{type(e).__name__}: {e}")
                emit(out, status="failed")
                return
            out["ok"] = True
            if kind == "fit_step":
                out["chi2"] = res.chi2
                out["chi2_prefit"] = res.chi2r
                out["dparams"] = {n: float(v) for n, v in
                                  zip(res.names, res.dparams)}
                out["errors"] = res.errors()
            elif kind == "residuals":
                out["chi2"] = res.chi2
                out["rms_us"] = res.rms_us
                out["n"] = len(res.time_resids)
            elif kind == "posterior":
                out["acceptance"] = res.acceptance_fraction
                out["nsteps"] = res.nsteps
                out["posterior"] = res.summary()
            else:
                out["phase_int"] = np.asarray(res.phase_int).tolist()
                out["phase_frac"] = np.asarray(res.phase_frac).tolist()
            emit(out)
        return cb

    payload = rec if journal_payload else None
    if kind in ("fit_step", "residuals"):
        model, toas = _load_pair(cache, rec["par"], rec["tim"])
        cls = FitStepRequest if kind == "fit_step" else ResidualsRequest
        fut = engine.submit(cls(toas, model, deadline_s=deadline_s,
                                tenant=tenant, payload=payload))
        fut.add_done_callback(finish(kind))
        if ack is not None:
            ack.expect(1)
        return 1
    if kind == "posterior":
        fut = engine.submit(_posterior_request(
            cache, rec, deadline_s, tenant, payload=payload))
        fut.add_done_callback(finish(kind))
        if ack is not None:
            ack.expect(1)
        return 1
    if kind == "phase":
        mjds = np.atleast_1d(np.asarray(rec["mjds"], np.float64))
        seg_min = float(rec.get("seg_min", 60.0))
        pad = seg_min / 1440.0
        pcs = _polycos_for(cache, rec["par"], rec.get("obs", "@"),
                           float(mjds.min()) - pad,
                           float(mjds.max()) + pad, seg_min)
        idx = pcs._entry_for(mjds)
        segs = np.unique(idx)
        nsub = 0
        for s in segs:
            try:
                fut = engine.submit(PhasePredictRequest(
                    pcs.entries[int(s)], mjds[idx == s],
                    deadline_s=deadline_s, tenant=tenant))
            except Exception as e:
                # PARTIAL submit: the segments
                # already admitted WILL emit and release the pending
                # semaphore, so the count returned below must include
                # them; the shed remainder is reported through the
                # UNCOUNTED path, or the final session snapshot would
                # race the still-pending results. Catches EVERYTHING
                # (not just the ServeOverload backpressure signal):
                # any mid-fan failure after >=1 admission would
                # otherwise escape with the count lost
                report({"id": rid, "kind": "phase", "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "segments_submitted": nsub,
                        "segments_shed": int(len(segs) - nsub)})
                break
            fut.add_done_callback(finish("phase"))
            nsub += 1
        if ack is not None:
            ack.expect(nsub)
        return nsub
    raise ValueError(f"unknown request kind {kind!r}")


def _demo_requests(n: int, device=None):
    """Synthesize a mixed-shape workload: small simulated pulsars in
    three TOA-count classes + polyco phase reads. Delegates to
    ``pint_tpu_torch.serve.workload`` — the ONE workload builder, shared
    with bench_serve.py."""
    from pint_tpu_torch.serve.workload import DEMO_SIZES, build_workload

    return build_workload(n, sizes=DEMO_SIZES, base=1200,
                          prebuild=False, with_kinds=True,
                          entry_name="DEMO", device=device)()


def main(argv=None, stdin=None) -> int:
    p = argparse.ArgumentParser(
        prog="pint_serve",
        description="JSONL serving daemon over the continuous-"
                    "batching scheduler (pint_tpu_torch.serve)")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; "
                        "'cpu' serves on the CPU)")
    p.add_argument("--window-ms", type=float, default=None,
                   help="coalescing window (default "
                        "$PINT_TPU_SERVE_WINDOW_MS or 5)")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--queue-cap", type=int, default=None)
    p.add_argument("--demo", type=int, default=None, metavar="N",
                   help="serve N synthesized mixed requests instead "
                        "of reading stdin")
    p.add_argument("--journal", default=None,
                   help="append-only request journal (crash replay; "
                        "default $PINT_TPU_JOURNAL)")
    p.add_argument("--aot-dir", default=None,
                   help="AOT executable dir for warm restart "
                        "(default $PINT_TPU_AOT_DIR)")
    p.add_argument("--drain-timeout-s", type=float, default=None,
                   help="graceful-shutdown drain bound (default "
                        "$PINT_TPU_SERVE_DRAIN_TIMEOUT_S or 30)")
    p.add_argument("--trace-jsonl", default=None, metavar="PATH",
                   help="stream completed tracer spans as JSONL to "
                        "PATH (default $PINT_TPU_TRACE_STREAM; "
                        "implies tracing on)")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="serve Prometheus /metrics + /healthz on "
                        "this port (0 = ephemeral, announced as an "
                        "event line; default $PINT_TPU_METRICS_PORT "
                        "or off)")
    p.add_argument("--worker-id", default=None, metavar="ID",
                   help="fleet worker identity: admits "
                        "are owner-stamped, a lease heartbeat rides "
                        "the shared journal, and restart replay is "
                        "scoped to THIS worker's records — one "
                        "pint_serve --worker-id per process over a "
                        "shared --journal is the cross-process fleet")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="run N in-process fleet workers over one "
                        "shared journal (FleetFront: lease expiry "
                        "re-homes a dead worker's requests onto "
                        "survivors); requires --journal")
    args = p.parse_args(argv)
    if args.fleet is not None and args.worker_id is not None:
        p.error("--fleet and --worker-id are mutually exclusive "
                "(the front names its own workers)")

    # handlers BEFORE the torch import: startup takes seconds (CUDA
    # init, the warm-restart priming), and a signal landing in that
    # window would otherwise hit the default handler — process killed,
    # lines already written to stdin silently dropped
    prev_handlers = _install_signal_handlers()
    try:
        from pint_tpu_torch import resolve_device
        from pint_tpu_torch.config import serve_drain_timeout_s

        device = resolve_device(args.device)
        drain_timeout = serve_drain_timeout_s() \
            if args.drain_timeout_s is None else args.drain_timeout_s

        if args.trace_jsonl is not None:
            from pint_tpu_torch import obs

            obs.configure(stream=args.trace_jsonl)

        from pint_tpu_torch import config as _config
        from pint_tpu_torch.serve import ServeEngine

        # (par, tim) cache: hoisted above engine construction because
        # the fleet replay factory closes over it — re-homed requests
        # rebuild against the same loaded pulsars as stdin ones
        cache: dict = {"device": device}
        fleet = None
        worker_lease = None
        engine_kw = dict(
            window_s=None if args.window_ms is None
            else args.window_ms / 1e3,
            max_batch=args.max_batch, queue_cap=args.queue_cap,
            device=device)
        if args.fleet is not None:
            from pint_tpu_torch.serve import FleetFront

            journal_path = args.journal
            if journal_path is None:
                journal_path = _config.journal_path()
            if journal_path is None:
                p.error("--fleet requires --journal (the shared "
                        "replicated log is the fleet's ownership "
                        "protocol)")
            engine = fleet = FleetFront(
                factory=_line_factory(cache), n=args.fleet,
                journal=journal_path, aot_dir=args.aot_dir,
                engine_kwargs=engine_kw, start=False)
        else:
            engine = ServeEngine(
                aot_dir=args.aot_dir, journal=args.journal,
                worker_id=args.worker_id, **engine_kw)
            if args.worker_id is not None and \
                    engine.journal is not None:
                from pint_tpu_torch.serve import WorkerLease

                worker_lease = WorkerLease(engine.journal,
                                           args.worker_id)
                worker_lease.start()

        # metrics plane: /metrics + /healthz on a stdlib
        # daemon thread — reads registry/breaker state only, never
        # the engine lock, so a scrape cannot perturb admission or
        # an in-flight drain
        metrics_srv = None
        mport = args.metrics_port if args.metrics_port is not None \
            else _config.metrics_port()
        if mport is not None:
            from pint_tpu_torch.obs import metrics as _om

            def _health(engine=engine, fleet=fleet, _om=_om):
                h = _om.default_health()
                try:
                    # per-pool breaker state + learned EWMA
                    # rate + in-flight depth — router leaf-lock reads
                    # only, never an engine lock (the scrape contract
                    # tests/test_metrics.py asserts by holding
                    # eng._lock while hitting /healthz)
                    if fleet is not None:
                        h["pools"] = fleet.health_blocks()
                        h["fleet"] = {"live": fleet.live_workers()}
                    else:
                        h["pools"] = engine.router.health_block()
                except Exception:
                    pass
                return h

            metrics_srv = _om.MetricsServer(
                port=mport, health_fn=_health).start()
            print(json.dumps({"event": "metrics_server",
                              "port": metrics_srv.port}), flush=True)
    except _Shutdown as sig:
        _ignore_signals()
        shed = 0 if args.demo is not None else \
            _shed_pending_stdin(stdin)
        print(json.dumps({"event": "shutdown", "signal": str(sig),
                          "during": "startup", "shed": shed}),
              flush=True)
        _restore_signal_handlers(prev_handlers)
        return 0

    out_lock = locks.make_lock("serve.cli_stdout")
    pending = threading.Semaphore(0)
    nsub = 0

    def raw_emit(obj):
        with out_lock:
            print(json.dumps(obj), flush=True)
        pending.release()

    def report(obj):
        """Result line for a request that was never admitted — NOT
        via emit: its semaphore release is the per-SUBMITTED-request
        completion count."""
        with out_lock:
            print(json.dumps(obj), flush=True)

    shutdown_reason = None
    if args.demo is not None:
        from pint_tpu_torch.serve import ServeOverload

        reqs = _demo_requests(args.demo, device=device)
        engine.start()
        try:
            for kind, rq in reqs:
                try:
                    fut = engine.submit(rq)
                except ServeOverload as e:
                    # backpressure during the demo burst sheds, never
                    # crashes the daemon
                    report({"kind": kind, "ok": False,
                            "error": repr(e)})
                    continue

                def cb(fut, kind=kind):
                    try:
                        fut.result(timeout=0)
                        raw_emit({"kind": kind, "ok": True})
                    except Exception as e:
                        raw_emit({"kind": kind, "ok": False,
                                  "error": repr(e)})
                fut.add_done_callback(cb)
                nsub += 1
        except _Shutdown as sig:
            shutdown_reason = str(sig)
            _ignore_signals()
            report({"event": "shutdown", "signal": shutdown_reason,
                    "drain_timeout_s": drain_timeout})
    else:
        engine.start()

        def fleet_emit(obj, status="served"):
            # fleet mode: the WORKER engine journals each single-
            # submission request (payload = the line record, owner =
            # the worker) so re-homing works at request granularity;
            # the line-level journal + _LineAck stay out of the way
            raw_emit(obj)

        def handle(rec):
            nonlocal nsub
            if rec.get("kind") in ("stats", "profile"):
                # introspection/window control: answered inline,
                # never journaled (a journaled stats line would
                # replay forever — it can never receive a terminal
                # ack; a profile window is a point-in-time act)
                _submit_line(engine, cache, rec, None, report)
                return
            if fleet is not None:
                nsub += _submit_line(engine, cache, rec, fleet_emit,
                                     report, journal_payload=True)
                return
            rid = rec.get("id") or uuid.uuid4().hex
            ack = _LineAck(engine.journal, rid)
            if engine.journal is not None:
                engine.journal.admit(rid, rec,
                                     tenant=rec.get("tenant"),
                                     worker=args.worker_id)

            def emit(obj, status="served", _ack=ack):
                raw_emit(obj)
                _ack.emitted(status)

            try:
                nsub += _submit_line(engine, cache, rec, emit,
                                     report, ack=ack)
            except _Shutdown:
                # NOT the record's fault: leave it UNACKED so the
                # journal replays it on restart (a terminal 'failed'
                # ack here would silently drop it — the record was
                # mid-submit when the signal landed). Without a
                # journal nothing will replay it, so the client gets
                # an explicit shed line instead.
                if engine.journal is None:
                    report({"id": rid, "status": "shed",
                            "reason": "shutdown"})
                raise
            except BaseException:
                ack.fail()  # terminal: never replay a poison record
                raise

        def replay_journal():
            """Re-admit the records a previous process died holding
            (no terminal ack in the journal). Runs BEFORE stdin so
            recovered work is first in line. Worker mode scopes the
            replay to THIS worker's owner-stamped records — a peer's
            unacked work belongs to its lease (the fleet re-home
            protocol moves it, not a restart); fleet mode replays
            everything (the front owns the whole journal)."""
            nonlocal nsub
            if engine.journal is None:
                return
            if fleet is not None:
                # engine-level records: the payload IS the line
                # record, so the stale rid acks terminally and the
                # work resubmits fresh (new rid, new owner) through
                # the same path stdin takes
                for jrec in engine.journal.unacknowledged():
                    rec = jrec.get("payload") or {}
                    engine.journal.ack(jrec["rid"], "replayed")
                    try:
                        n = _submit_line(engine, cache, rec,
                                         fleet_emit, report,
                                         journal_payload=True)
                        nsub += n
                        ri = engine.metrics.restart_info
                        ri["replayed"] = ri.get("replayed", 0) + n
                    except _Shutdown:
                        raise
                    except Exception as e:
                        report({"id": rec.get("id"), "ok": False,
                                "error": f"replay: "
                                         f"{type(e).__name__}: {e}"})
                return
            for jrec in engine.journal.unacknowledged(
                    owner=args.worker_id):
                rec = jrec.get("payload") or {}
                engine.journal.ack(jrec["rid"], "replayed")
                ack = _LineAck(engine.journal, jrec["rid"])

                def emit(obj, status="served", _ack=ack):
                    raw_emit(obj)
                    _ack.emitted(status)

                try:
                    n = _submit_line(engine, cache, rec, emit,
                                     report, ack=ack)
                    nsub += n
                    engine.metrics.restart_info["replayed"] = \
                        engine.metrics.restart_info.get(
                            "replayed", 0) + n
                except _Shutdown:
                    raise  # leave unacked: replayable next start
                except Exception as e:
                    ack.fail()  # terminal: no infinite replay loop
                    report({"id": jrec.get("rid"), "ok": False,
                            "error": f"replay: "
                                     f"{type(e).__name__}: {e}"})

        try:
            replay_journal()
            for line in (sys.stdin if stdin is None else stdin):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    rec = json.loads(line)
                    handle(rec)
                except _Shutdown:
                    raise
                except Exception as e:
                    # malformed line (or a zero-submission overload):
                    # report through the uncounted path
                    report({"ok": False,
                            "error": f"{type(e).__name__}: {e}",
                            "line": line[:200]})
        except _Shutdown as sig:
            shutdown_reason = str(sig)
            # a SECOND signal must not abort the bounded drain —
            # the shed lines + snapshot below are the contract
            _ignore_signals()
            report({"event": "shutdown", "signal": shutdown_reason,
                    "drain_timeout_s": drain_timeout})

    # graceful stop: bounded drain, then every still-queued request
    # is shed with a labeled ShutdownShed (emitted above as
    # {"status": "shed", "reason": "shutdown"}); unbounded only when
    # no signal asked us to leave
    if shutdown_reason:
        # SIGTERM-drain flight dump: capture what the
        # engine was doing when the signal landed — BEFORE the drain
        # mutates the queue, so the dump shows the pre-shutdown state
        from pint_tpu_torch import obs

        obs.flight_dump("sigterm_drain", signal=shutdown_reason,
                        drain_timeout_s=drain_timeout)
    if worker_lease is not None:
        # stop heartbeating BEFORE the drain: a peer's sweep must be
        # free to re-home whatever this worker cannot drain in time
        worker_lease.stop()
    engine.stop(drain=True,
                timeout=drain_timeout if shutdown_reason else None)
    for _ in range(nsub):
        pending.acquire()
    snap = engine.metrics.snapshot()
    snap["metric"] = "serve_session"
    if shutdown_reason:
        snap["shutdown_signal"] = shutdown_reason
    if metrics_srv is not None:
        snap["metrics_port"] = metrics_srv.port
        metrics_srv.close()
    with out_lock:
        print(json.dumps(snap), flush=True)
    print(engine.metrics.report(), file=sys.stderr)
    _restore_signal_handlers(prev_handlers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
