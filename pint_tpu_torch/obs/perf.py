"""Performance-attribution plane: compile ledger, roofline accounting,
dispatch-wall decomposition arming, on-demand profiler windows (a port
of pint_tpu/obs/perf.py; the ledger, the metric names, the window
bounds and rate limits are the reference's).

- **compile ledger** (``CompileLedger``): every first call the
  supervisor detects (``first_call`` per dispatch key) reports
  ``(key, backend, compile_wall, flops, bytes_accessed, when)`` through
  ``note_compile``. The ledger is registry-backed (``pint_tpu_perf_*``;
  the snapshot is a derived view) and optionally JSONL-persisted
  (``$PINT_TPU_COMPILE_LEDGER``): a restarted process reads the file
  back as ``prior`` entries. A call site that knows its work registers
  it: the hand kernel K1 (``ops.z2_harmonics``) its analytic operation
  and byte counts on every launch.

- **cost probe** (``cost_probe``): the reference reads XLA's
  ``cost_analysis`` of a compiled program, which eager torch does not
  have. The port runs the function once under
  ``torch.utils.flop_counter.FlopCounterMode`` and reports its FLOPs;
  the counter sees matmul-class ops only (mm, bmm, addmm, convolution,
  attention), so elementwise work, reductions and factorizations
  (Cholesky, triangular solves) count zero, and ``bytes_accessed`` is
  not reported. Call sites with an analytic count pass it instead.

- **roofline accounting**: ``roofline``/``roofline_block`` derive
  achieved FLOP/s, bytes/s, arithmetic intensity and the achieved
  fraction against ``PEAKS`` from ledger cost / a measured wall, and
  publish them as per-key gauges. ``PEAKS`` holds one entry, "cuda":
  NVIDIA's H100 SXM data-sheet peaks (67 TFLOP/s, 3.35 TB/s; a card
  below its 700 W limit runs slower). A device without an entry gets no
  achieved fraction: a fabricated host peak would turn a latency-bound
  number into a utilization claim.

- **dispatch-wall decomposition arming**: ``enabled()`` is the one
  branch the supervisor consults before splitting a guarded dispatch's
  wall into queue_wait / host_assembly / device_wall / collect
  (``$PINT_TPU_PERF``; the timings live in ``runtime/supervisor.py``,
  the histogram family in ``RuntimeMetrics.perf``).

- **profiler windows** (``ProfilerWindows``): a bounded, rate-limited
  wrapper over ``torch.profiler.profile``. Armed by
  ``$PINT_TPU_PROFILE_DIR``; opened by ``request_window`` or
  ``auto_window`` (one-shot on ``slo_burn``/breaker-open, one window
  per episode by the per-reason rate limit, never raising into the
  incident path). Every window writes ``window.json`` (the triggering
  reason, the flight-dump path, the causal span ids), the device trace
  (``trace.json``, ``export_chrome_trace``) and, with tracing on, the
  span ring (``spans.json``). torch's profiler is thread-local: one
  daemon thread per window starts it, waits for the stop and stops it,
  and the caller waits for each under a join timeout, so a wedged
  device degrades the window to a labelled ``start_timeout`` or
  ``abandoned`` status, never a hung caller. Where the installed torch
  offers it, the window records the CPU ops of every thread
  (``profile_all_threads``); device kernels are traced process-wide.
  Windows add no dispatch: no dispatch path consults the profiler.

Everything host-side here is stdlib + the obs registry; torch is
imported only inside the probe and the window thread. ``obs.reset()``
drops the ledger, the profiler and the arming cache.
"""

from __future__ import annotations

import json
import os
import threading

from pint_tpu_torch.runtime import locks
import time
from typing import Optional

__all__ = ["CompileLedger", "ProfilerWindows", "PEAKS", "cost_probe",
           "get_ledger", "get_profiler", "ledger_summary", "note_compile",
           "roofline", "roofline_block", "roofline_from_latency",
           "request_window", "auto_window",
           "enabled", "configure", "reset", "status"]

# per-device-type peak table for the achieved-fraction roofline: NVIDIA's
# H100 SXM data sheet (67 TFLOP/s outside the tensor cores, 3.35 TB/s of
# HBM3, at the full 700 W limit). A device type absent from the table
# gets no achieved fraction.
PEAKS = {
    "cuda": {"flops": 67e12, "bytes_per_s": 3.35e12},
}

# auto (incident-triggered) window length when the caller gives none
_AUTO_WINDOW_S = 5.0
# hang-proof bounds on trace control: start matters MORE than stop —
# the auto triggers run on incident paths (breaker trip = the device
# just proved unresponsive), so an unbounded profiler start could wedge
# the very failover that fired it
_START_JOIN_S = 10.0
_STOP_JOIN_S = 30.0


_PROBE_THREADS: set = set()
_PROBE_LOCK = locks.make_lock("obs.perf_probe")


def _note_probe_thread(t: threading.Thread):
    """Track a deferred cost probe so interpreter exit waits for it: a
    daemon thread killed inside a torch op at finalization aborts the
    process ("terminate called without an active exception")."""
    with _PROBE_LOCK:
        if not _PROBE_THREADS:
            import atexit

            atexit.register(join_cost_probes)
        _PROBE_THREADS.add(t)


def join_cost_probes(timeout_s: float = 30.0):
    """Wait (at most ``timeout_s``) for every deferred cost probe to end:
    interpreter exit does, and so does a measurement that must not share
    the host with one."""
    deadline = time.monotonic() + timeout_s
    with _PROBE_LOCK:
        threads = list(_PROBE_THREADS)
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))


def cost_probe(fn, args) -> dict:
    """FLOPs of one call ``fn(*args)`` counted by
    ``torch.utils.flop_counter.FlopCounterMode``: ``{"flops": ...}``,
    or ``{}`` when the counter saw none or the call failed. The counter
    sees matmul-class ops only (mm, bmm, addmm, convolution, attention):
    elementwise ops, reductions and factorizations count zero, and no
    byte count is reported (module docstring). The probe RUNS the
    function once more; callers probe once per key (ledger dedup).
    Never raises."""
    out: dict = {}
    try:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            fn(*args)
        flops = fc.get_total_flops()
        if flops > 0:
            out["flops"] = float(flops)
    except Exception as e:
        try:
            from pint_tpu_torch.logging import log

            log.debug("cost probe unavailable: %r", e)
        except Exception:
            pass
    return out


def _peak(backend) -> Optional[dict]:
    """The ``PEAKS`` entry of a backend label ("cuda:0" -> "cuda")."""
    return PEAKS.get(str(backend or "").split(":")[0])


class CompileLedger:
    """Registry-backed, optionally JSONL-persisted compile ledger
    (module docstring). ``record`` merges by key — the compiles
    counter counts NEW keys only, so the registry counter and
    ``snapshot()['compiles']`` are the same number by construction
    (the registry-parity discipline). Never raises: losing a ledger
    line must not fail the dispatch that just compiled."""

    def __init__(self, path: Optional[str] = None):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        self.path = config.compile_ledger_path() \
            if path is None else path
        self._lock = locks.make_lock("obs.perf_ledger")
        self._entries: dict = {}
        self._prior: dict = {}
        # counters are SCOPE-labelled per instance (the
        # RuntimeMetrics discipline): a configure() that swaps in a
        # fresh ledger mid-process must not inherit the old
        # instance's counts — each instance's registry series and
        # its snapshot stay the same number by construction
        self._scope = om.new_scope("ledger")
        self._c_compiles = om.counter(
            "pint_tpu_perf_compiles_total",
            "executables ledgered this process (new keys)"
        ).child(scope=self._scope)
        # the reference's AOT-restore count, kept for ledger parity (the
        # port restores no executables: it stays 0 unless a caller says
        # otherwise)
        self._c_aot = om.counter(
            "pint_tpu_perf_aot_restored_total",
            "ledgered keys that came from an AOT restore"
        ).child(scope=self._scope)
        self._g_wall = om.gauge(
            "pint_tpu_perf_compile_wall_seconds",
            "ledgered first-call/compile wall per key")
        self._g_flops = om.gauge(
            "pint_tpu_perf_cost_flops",
            "FLOPs per ledgered key (analytic or counted)")
        self._g_bytes = om.gauge(
            "pint_tpu_perf_cost_bytes",
            "bytes accessed per ledgered key (analytic)")
        if self.path:
            self._load_prior()

    # -- persistence ---------------------------------------------------

    def _load_prior(self):
        """Prior-process entries from the JSONL file: a restarted
        worker knows which executables existed before it (kept
        separate from this process's entries — `prior` in the
        snapshot — so the registry parity stays exact)."""
        try:
            with open(self.path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line from a crash
                    key = rec.pop("key", None)
                    if key:
                        self._prior[key] = rec
        except OSError:
            pass

    def _persist(self, key: str, entry: dict):
        if not self.path:
            return
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(dict(entry, key=key),
                                    sort_keys=True, default=str)
                         + "\n")
                fh.flush()
        except Exception:
            pass  # the ledger must never fail a dispatch

    # -- recording -----------------------------------------------------

    def record(self, key: str, backend: Optional[str] = None,
               compile_wall_s: Optional[float] = None,
               aot_restored: bool = False,
               kind: Optional[str] = None,
               fn=None, args=None, defer_cost: bool = False,
               **cost) -> Optional[dict]:
        """Merge one compile observation into the ledger. With an
        ``fn``+``args`` pair the FLOP-counter probe (``cost_probe``)
        runs ONCE per key (a per-key in-flight marker under the lock
        dedups concurrent enrichers). The probe runs the function once
        more, so ``defer_cost=True`` runs it on a BACKGROUND daemon
        thread; an analytic count passed as ``flops``/``bytes_accessed``
        needs no probe. Returns the entry (a copy, in-flight markers
        stripped), or None on failure."""
        try:
            key = str(key)
            fields: dict = {}
            if backend is not None:
                fields["backend"] = str(backend)
            if kind is not None:
                fields["kind"] = str(kind)
            if compile_wall_s is not None:
                fields["compile_wall_s"] = round(
                    float(compile_wall_s), 6)
            for name in ("flops", "bytes_accessed", "temp_bytes",
                         "peak_bytes"):
                if cost.get(name) is not None:
                    fields[name] = float(cost[name])
            snap, new, need_probe = self._merge(
                key, fields, aot_restored,
                want_probe=fn is not None)
            if need_probe:
                if defer_cost:
                    t = threading.Thread(
                        target=self._probe_and_merge,
                        args=(key, fn, args), daemon=True,
                        name="pint-perf-cost")
                    _note_probe_thread(t)
                    t.start()
                else:
                    self._probe_and_merge(key, fn, args)
                    snap = self.get(key) or snap
            return snap
        except Exception:
            return None

    def _merge(self, key: str, fields: dict, aot_restored: bool,
               want_probe: bool):
        """Lock-disciplined entry merge: ALL entry mutation happens
        under ``self._lock`` (snapshot() copies under the same lock,
        so a scrape can never see a torn entry), gauges/counters/
        persistence run outside it from the copied view."""
        with self._lock:
            entry = self._entries.get(key)
            new = entry is None
            if new:
                entry = self._entries[key] = {
                    "when": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
                    "aot_restored": False,
                }
            changed = new or \
                any(entry.get(k) != v for k, v in fields.items()) \
                or (aot_restored and not entry["aot_restored"])
            entry.update(fields)
            if aot_restored:
                entry["aot_restored"] = True
            has_cost = "flops" in entry or "bytes_accessed" in entry
            need_probe = want_probe and not has_cost and \
                not entry.get("_probing")
            if need_probe:
                entry["_probing"] = True
            snap = {k: v for k, v in entry.items()
                    if not k.startswith("_")}
        self._publish_gauges(key, snap)
        if new:
            self._c_compiles.inc()
            if aot_restored:
                self._c_aot.inc()
        if changed:
            # merges persist too (the loader is last-wins per key): an
            # entry gains its first-call wall or its cost in a LATER
            # merge, and the JSONL post-mortem must carry it
            self._persist(key, snap)
        return snap, new, need_probe

    def _probe_and_merge(self, key: str, fn, args):
        """The cost-probe half (possibly on a background thread):
        probe outside the lock, merge under it, then persist the
        enriched line (the JSONL loader is last-wins per key)."""
        try:
            probed = cost_probe(fn, args or ())
        except Exception:
            probed = {}
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.pop("_probing", None)
            entry.update(probed)
            snap = {k: v for k, v in entry.items()
                    if not k.startswith("_")}
        if probed:
            self._publish_gauges(key, snap)
            self._persist(key, snap)

    def _publish_gauges(self, key: str, snap: dict):
        if snap.get("compile_wall_s") is not None:
            self._g_wall.set(snap["compile_wall_s"], key=key)
        if snap.get("flops") is not None:
            self._g_flops.set(snap["flops"], key=key)
        if snap.get("bytes_accessed") is not None:
            self._g_bytes.set(snap["bytes_accessed"], key=key)

    # -- reads ---------------------------------------------------------

    def get(self, key: str) -> Optional[dict]:
        """This process's entry for ``key``, falling back to a prior
        run's persisted entry."""
        with self._lock:
            e = self._entries.get(str(key))
            if e is None:
                e = self._prior.get(str(key))
            return {k: v for k, v in e.items()
                    if not k.startswith("_")} \
                if e is not None else None

    def snapshot(self) -> dict:
        with self._lock:
            entries = {k: {f: v for f, v in e.items()
                           if not f.startswith("_")}
                       for k, e in sorted(self._entries.items())}
            prior = len(self._prior)
        return {"compiles": len(entries),
                "aot_restored": sum(
                    1 for e in entries.values()
                    if e.get("aot_restored")),
                "total_compile_wall_s": round(sum(
                    e.get("compile_wall_s") or 0.0
                    for e in entries.values()), 4),
                "prior": prior,
                "path": self.path,
                "entries": entries}


# ------------------------------------------------------------------
# roofline accounting
# ------------------------------------------------------------------


def roofline(entry: dict, wall_s: float,
             backend: Optional[str] = None) -> Optional[dict]:
    """Roofline block for one ledger entry at a measured pure-step
    wall: achieved GFLOP/s + GB/s, arithmetic intensity (FLOP/byte),
    and — when the backend is in ``PEAKS`` — the achieved fraction
    of peak. None when the entry carries no cost."""
    if not entry or not wall_s or wall_s <= 0:
        return None
    flops = entry.get("flops")
    nbytes = entry.get("bytes_accessed")
    if not flops and not nbytes:
        return None
    out: dict = {"wall_ms": round(wall_s * 1e3, 3),
                 "source": "compile_ledger"}
    peak = _peak(backend or entry.get("backend"))
    if flops:
        out["flops"] = flops
        out["gflops_achieved"] = round(flops / wall_s / 1e9, 2)
        if peak:
            out["achieved_frac_flops"] = round(
                flops / wall_s / peak["flops"], 6)
    if nbytes:
        out["bytes"] = nbytes
        out["gbps_achieved"] = round(nbytes / wall_s / 1e9, 2)
        if peak:
            out["achieved_frac_hbm"] = round(
                nbytes / wall_s / peak["bytes_per_s"], 6)
    if flops and nbytes:
        out["arith_intensity"] = round(flops / nbytes, 4)
    return out


def roofline_block(key: str, wall_s: float,
                   backend: Optional[str] = None) -> Optional[dict]:
    """Ledger-derived roofline for one key, publishing the per-key achieved-FLOP/s and
    arithmetic-intensity gauges."""
    entry = get_ledger().get(key)
    block = roofline(entry or {}, wall_s, backend)
    if block is None:
        return None
    block["key"] = str(key)
    try:
        from pint_tpu_torch.obs import metrics as om

        if block.get("gflops_achieved") is not None:
            om.gauge("pint_tpu_perf_achieved_gflops",
                     "achieved GFLOP/s per key (ledger cost / "
                     "measured pure-step wall)").set(
                block["gflops_achieved"], key=str(key))
        if block.get("arith_intensity") is not None:
            om.gauge("pint_tpu_perf_arith_intensity",
                     "arithmetic intensity (FLOP/byte) per key").set(
                block["arith_intensity"], key=str(key))
    except Exception:
        pass
    return block


def roofline_from_latency(latency_snapshot: Optional[dict],
                          backend: Optional[str] = None
                          ) -> Optional[dict]:
    """Per-key rooflines joined from a supervisor ``latency``
    snapshot ({"pool/key": {"dispatch_wall": {...}}}) and the
    ledger's cost entries.
    Output keys KEEP the pool prefix (a degraded run's device and
    host rows for one class must not collide), and host-pool rows
    are skipped entirely: the ledger cost describes the DEVICE
    executable, so scoring a pinned host wall against it (and the
    device backend's peak) would be exactly the laundered
    utilization claim the PEAKS table refuses. Walls use the exact
    ``mean_ms`` (sum/count), not the bucket-upper-edge p50. Keys
    with no ledgered cost (or no wall yet) are skipped."""
    led = get_ledger()
    out: dict = {}
    for row_key, metrics_ in (latency_snapshot or {}).items():
        pool, _, key = str(row_key).partition("/")
        if not key or pool.startswith("host"):
            continue
        dw = (metrics_ or {}).get("dispatch_wall") or {}
        wall_ms = dw.get("mean_ms") or dw.get("p50_ms")
        if not wall_ms:
            continue
        entry = led.get(key)
        if entry is None:
            continue
        block = roofline(entry, wall_ms / 1e3,
                         backend or entry.get("backend"))
        if block is not None:
            out[row_key] = block
    return out or None


def ledger_summary(max_keys: int = 64) -> dict:
    """The compact ``compiles`` block of a benchmark artifact: counts
    and, for at most ``max_keys`` keys, each one's compile wall and
    costs (an artifact stays a summary)."""
    snap = get_ledger().snapshot()
    keys = {}
    for k, e in list(snap["entries"].items())[:max_keys]:
        keys[k] = {f: e[f] for f in
                   ("backend", "compile_wall_s", "flops",
                    "bytes_accessed", "peak_bytes", "aot_restored")
                   if e.get(f) is not None}
    return {"compiles": snap["compiles"],
            "aot_restored": snap["aot_restored"],
            "total_compile_wall_s": snap["total_compile_wall_s"],
            "prior": snap["prior"],
            "keys": keys}


# ------------------------------------------------------------------
# on-demand profiler windows
# ------------------------------------------------------------------


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:48]


def _make_profiler():
    """A ``torch.profiler.profile`` over the CPU and, when CUDA is up,
    the card, recording the CPU ops of every thread where the installed
    torch offers it (dispatches run on the supervisor's workers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        return profile(activities=acts, experimental_config=
                       _ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=acts)


class ProfilerWindows:
    """Bounded, rate-limited ``torch.profiler`` windows (module
    docstring). One window open at a time; per-reason rate
    limit gives the one-window-per-episode contract for the auto
    (incident) triggers; disarmed (no dir) everything is a cheap
    labeled refusal and NOTHING is recorded."""

    def __init__(self, dirpath: Optional[str] = None,
                 max_s: Optional[float] = None,
                 min_interval_s: float = 60.0):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        self.dir = config.profile_dir() if dirpath is None \
            else dirpath
        self.max_s = config.profile_max_s() if max_s is None \
            else float(max_s)
        self.min_interval_s = float(min_interval_s)
        self._lock = locks.make_lock("obs.profiler")
        self._open: Optional[dict] = None
        self._last_by_reason: dict = {}
        self._n = 0
        self.last: Optional[dict] = None
        # scope-labelled per instance (the CompileLedger/
        # RuntimeMetrics discipline): a configure() that swaps in a
        # fresh profiler must not inherit the old instance's counts
        # in its own status()
        self._scope = om.new_scope("prof")
        self._c_windows = om.counter(
            "pint_tpu_perf_profile_windows_total",
            "profiler windows opened").child(scope=self._scope)
        self._c_suppressed = om.counter(
            "pint_tpu_perf_profile_suppressed_total",
            "profiler window requests refused (open/rate-limited)"
        ).child(scope=self._scope)
        self._c_errors = om.counter(
            "pint_tpu_perf_profile_errors_total",
            "profiler window start/stop failures"
        ).child(scope=self._scope)

    @property
    def armed(self) -> bool:
        return bool(self.dir)

    # -- the window lifecycle ------------------------------------------

    def request(self, seconds=None, reason: str = "manual",
                **extra) -> dict:
        """Open one bounded window capturing the NEXT dispatches.
        Never raises (the incident path calls this); returns a
        labeled status dict either way."""
        try:
            return self._request(seconds, reason, extra)
        except Exception as e:  # never into the caller's path
            try:
                self._c_errors.inc()
            except Exception:
                pass
            return {"ok": False, "reason": str(reason),
                    "error": f"{type(e).__name__}: {e}"}

    def _request(self, seconds, reason: str, extra: dict) -> dict:
        if not self.armed:
            return {"ok": False, "reason": reason,
                    "error": "profiler not armed "
                             "(set $PINT_TPU_PROFILE_DIR)"}
        try:
            seconds = float(seconds) if seconds else 0.0
        except (TypeError, ValueError):
            seconds = 0.0
        if not seconds > 0:
            seconds = min(_AUTO_WINDOW_S, self.max_s)
        seconds = min(seconds, self.max_s)
        now = time.monotonic()
        with self._lock:
            if self._open is not None:
                self._c_suppressed.inc()
                return {"ok": False, "reason": reason,
                        "error": "a profiler window is already open"}
            last = self._last_by_reason.get(reason)
            if last is not None and \
                    now - last < self.min_interval_s:
                self._c_suppressed.inc()
                return {"ok": False, "reason": reason,
                        "error": "rate-limited (one window per "
                                 f"{self.min_interval_s:.0f}s per "
                                 "reason)"}
            prev_stamp = last
            self._last_by_reason[reason] = now
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            wdir = os.path.join(
                self.dir, f"window-{stamp}-{self._n:03d}-"
                          f"{_slug(reason)}")
            self._n += 1
            meta = {"reason": reason, "seconds": seconds,
                    "dir": wdir, "status": "open",
                    "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())}
            self._open = meta
        # causal cross-link: the triggering context's span ids and
        # any caller context (the flight-dump path on auto windows)
        try:
            from pint_tpu_torch import obs

            ctx = obs.current()
            if ctx is not None:
                meta["trace"], meta["span"] = ctx
        except Exception:
            pass
        if extra:
            meta["extra"] = {k: v for k, v in extra.items()
                             if v is not None}
        # BOUNDED start, same discipline as the stop: the auto
        # triggers fire from incident paths (a breaker trip IS the
        # moment the device just proved unresponsive), and starting the
        # profiler touches the device — it must never be able to wedge
        # the failover that called it. torch's profiler is thread-local:
        # ONE daemon thread per window starts it, waits for the stop
        # request and stops it (``_run_window``). On a start timeout the
        # thread is abandoned with its stop already requested, so a
        # start that completes late stops at once.
        start_done = threading.Event()
        start_err: list = []
        meta["_stop_req"] = threading.Event()
        meta["_stop_done"] = threading.Event()
        threading.Thread(target=self._run_window,
                         args=(meta, start_done, start_err),
                         daemon=True, name="pint-profile-window").start()
        started = start_done.wait(_START_JOIN_S) and not start_err
        if not started:
            meta["_stop_req"].set()
            if start_err:
                e = start_err[0]
                meta["status"] = "aborted"
                meta["error"] = f"{type(e).__name__}: {e}"
            else:
                meta["status"] = "start_timeout"
            self._c_errors.inc()
        self._write_meta(meta)
        try:
            from pint_tpu_torch import obs

            obs.event("profile.window", reason=reason, dir=wdir,
                      status=meta["status"], seconds=seconds)
        except Exception:
            pass
        if not started:
            with self._lock:
                self._open = None
                self.last = meta
                # a window that never opened must not burn the
                # episode's rate-limit slot — the incident that
                # armed the feature still deserves its one trace
                if self._last_by_reason.get(reason) == now:
                    if prev_stamp is None:
                        self._last_by_reason.pop(reason, None)
                    else:
                        self._last_by_reason[reason] = prev_stamp
            return {"ok": False, "reason": reason, "dir": wdir,
                    "error": meta.get("error", meta["status"])}
        self._c_windows.inc()
        t = threading.Thread(target=self._close_after,
                             args=(meta, seconds), daemon=True,
                             name="pint-profile-close")
        t.start()
        return {"ok": True, "reason": reason, "dir": wdir,
                "seconds": seconds}

    def _run_window(self, meta: dict, start_done, start_err: list):
        """The window's thread: start the profiler, wait for the stop
        request, stop it and write the device trace (module docstring:
        torch's profiler must start and stop on one thread)."""
        try:
            os.makedirs(meta["dir"], exist_ok=True)
            prof = _make_profiler()
            prof.start()
        except Exception as e:
            start_err.append(e)
            start_done.set()
            return
        start_done.set()
        meta["_stop_req"].wait()
        try:
            prof.stop()
            path = os.path.join(meta["dir"], "trace.json")
            prof.export_chrome_trace(path)
            meta["device_trace"] = path
            late = meta.get("status") == "abandoned"
            meta["status"] = "closed"
            if late:
                # the join timed out (a big trace writing slowly is
                # indistinguishable from a wedge at the time) but the
                # stop DID finish — upgrade the labelled abandon to the
                # eventual truth
                self._write_meta(meta)
        except Exception as e:
            meta["status"] = "aborted"
            meta["error"] = f"{type(e).__name__}: {e}"
            self._c_errors.inc()
        finally:
            meta["_stop_done"].set()

    def _close_after(self, meta: dict, seconds: float):
        time.sleep(seconds)
        self._stop(meta)

    def stop_open(self):
        """Force-close the open window now (tests, reset)."""
        with self._lock:
            meta = self._open
        if meta is not None:
            self._stop(meta)

    def _stop(self, meta: dict):
        # claim the window first: the deadline thread and a manual
        # stop must not both stop the profiler. The open slot is NOT
        # cleared until the final metadata lands — a poller that
        # sees ``open is None`` is guaranteed a terminal window.json
        with self._lock:
            if meta.get("_stopping") or self._open is not meta:
                return
            meta["_stopping"] = True
        meta["_stop_req"].set()
        if not meta["_stop_done"].wait(_STOP_JOIN_S):
            # hang-proof: a wedged device cannot hold the window open —
            # the window thread is abandoned, the window is labelled,
            # the caller's drain proceeds
            meta["status"] = "abandoned"
            self._c_errors.inc()
        # Perfetto-loadable cross-link: the span ring covering the
        # window, causal ids intact (obs.export writes the Chrome
        # trace-event wrapper)
        try:
            from pint_tpu_torch import obs

            if obs.recording():
                meta["spans"] = obs.export(
                    os.path.join(meta["dir"], "spans.json"))
        except Exception:
            pass
        self._write_meta(meta)
        with self._lock:
            if self._open is meta:
                self._open = None
            self.last = meta

    def _write_meta(self, meta: dict):
        try:
            os.makedirs(meta["dir"], exist_ok=True)
            path = os.path.join(meta["dir"], "window.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({k: v for k, v in meta.items()
                           if not k.startswith("_")},
                          fh, default=str, sort_keys=True)
                fh.flush()
            os.replace(tmp, path)
        except Exception:
            try:
                self._c_errors.inc()
            except Exception:
                pass

    def status(self) -> dict:
        with self._lock:
            open_ = self._open
            last = self.last
        return {"armed": self.armed, "dir": self.dir,
                "max_s": self.max_s,
                "windows": int(self._c_windows.value()),
                "suppressed": int(self._c_suppressed.value()),
                "errors": int(self._c_errors.value()),
                "open": {k: open_[k] for k in
                         ("reason", "dir", "seconds")}
                if open_ is not None else None,
                "last": {k: last[k] for k in
                         ("reason", "dir", "status")
                         if k in last}
                if last is not None else None}


# ------------------------------------------------------------------
# process-global plane (armed by env, like the tracer/monitor)
# ------------------------------------------------------------------

_LOCK = locks.make_lock("obs.perf_global")
_LEDGER: Optional[CompileLedger] = None
_PROFILER: Optional[ProfilerWindows] = None
_ENABLED: Optional[bool] = None


def get_ledger() -> CompileLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LOCK:
            if _LEDGER is None:
                _LEDGER = CompileLedger()
    return _LEDGER


def get_profiler() -> ProfilerWindows:
    global _PROFILER
    if _PROFILER is None:
        with _LOCK:
            if _PROFILER is None:
                _PROFILER = ProfilerWindows()
    return _PROFILER


def enabled() -> bool:
    """Is the dispatch-wall decomposition armed? ($PINT_TPU_PERF /
    ``configure(enabled=...)``.) The supervisor's one-branch gate —
    resolved once and cached until ``reset()``."""
    global _ENABLED
    e = _ENABLED
    if e is None:
        from pint_tpu_torch import config

        with _LOCK:
            if _ENABLED is None:
                _ENABLED = config.perf_enabled()
            e = _ENABLED
    return e


def note_compile(key: str, backend: Optional[str] = None,
                 compile_wall_s: Optional[float] = None,
                 aot_restored: bool = False,
                 kind: Optional[str] = None,
                 fn=None, args=None, defer_cost: bool = False,
                 **cost) -> Optional[dict]:
    """THE compile-site reporting surface (the supervisor's first call
    per key; a hand kernel's analytic cost). ``fn``+``args`` run the
    FLOP-counter probe once per key (``defer_cost=True``: on a
    background thread). Never raises."""
    try:
        return get_ledger().record(
            key, backend=backend, compile_wall_s=compile_wall_s,
            aot_restored=aot_restored, kind=kind, fn=fn,
            args=args, defer_cost=defer_cost, **cost)
    except Exception:
        return None


def request_window(seconds=None, reason: str = "manual",
                   **extra) -> dict:
    """Open one bounded profiler window. Never raises."""
    try:
        return get_profiler().request(seconds, reason=reason,
                                      **extra)
    except Exception as e:
        return {"ok": False, "reason": str(reason),
                "error": f"{type(e).__name__}: {e}"}


def auto_window(reason: str, **extra) -> Optional[dict]:
    """Incident-triggered one-shot window (slo_burn, breaker-open):
    short default length, per-reason rate limit = one window per
    episode, disarmed = a cheap no-op, NEVER raises into the
    incident path that called it."""
    try:
        prof = _PROFILER
        if prof is None:
            from pint_tpu_torch import config

            if not config.profile_dir():
                return None  # disarmed: don't even build the object
            prof = get_profiler()
        if not prof.armed:
            return None
        return prof.request(None, reason=reason, **extra)
    except Exception:
        return None


def configure(enabled: Optional[bool] = None, ledger_path=None,
              profile_dir=None, max_s: Optional[float] = None,
              min_interval_s: Optional[float] = None):
    """Explicitly (re)build the plane (tests, a measurement's armed and
    disarmed legs). Omitted arguments fall back to env/config; pass
    ``ledger_path=False`` / ``profile_dir=False`` to FORCE them off
    regardless of env."""
    global _LEDGER, _PROFILER, _ENABLED
    from pint_tpu_torch import config

    prof = _PROFILER
    if prof is not None:
        prof.stop_open()  # outside the lock: the stop is bounded
    with _LOCK:
        if ledger_path is False:
            ledger_path = ""
        _LEDGER = CompileLedger(path=ledger_path)
        pdir = profile_dir
        if pdir is False:
            pdir = ""
        elif pdir is None:
            pdir = config.profile_dir()
        kw = {}
        if min_interval_s is not None:
            kw["min_interval_s"] = min_interval_s
        _PROFILER = ProfilerWindows(dirpath=pdir, max_s=max_s, **kw)
        _ENABLED = config.perf_enabled() if enabled is None \
            else bool(enabled)


def reset():
    """Drop the plane; the next use re-reads the env (called from
    ``obs.reset()`` — the isolation contract)."""
    global _LEDGER, _PROFILER, _ENABLED
    prof = _PROFILER
    if prof is not None:
        try:
            prof.stop_open()
        except Exception:
            pass
    with _LOCK:
        _LEDGER = None
        _PROFILER = None
        _ENABLED = None


def status() -> dict:
    """The ``perf`` status block: ledger counts + profiler state
    (cheap — no probe, no torch)."""
    out: dict = {"decomposition_armed": enabled()}
    led = _LEDGER
    if led is not None:
        snap = led.snapshot()
        out["compiles"] = snap["compiles"]
        out["ledger_path"] = snap["path"]
    prof = _PROFILER
    if prof is not None:
        out["profiler"] = prof.status()
    return out
