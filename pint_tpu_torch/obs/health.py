"""Numerical-health plane: health vectors computed on the device and
evaluated on the host, shadow-oracle drift sampling, numerical-incident
forensics (a copy of pint_tpu/obs/health.py, imports rewritten; the
verdict logic, thresholds, metric names and incident reasons are the
reference's).

- **health vectors**: the fit step and loop, the GLS solve, the
  streaming chunk accumulator and the CG finalize can return a few
  cheap reductions (non-finite counts, max |whitened residual|, CG
  iterations and final relative residual, Cholesky ``ok`` flags, the
  streaming colmax rescale, chi2) as EXTRA OUTPUTS of the call they
  already make, so health adds no dispatch. The taps are built only
  when ``config.health_enabled`` says so: disarmed, the step runs
  exactly the ops it runs without them.

- **HealthMonitor.observe** is the one host-side consumer: it
  evaluates each vector against the validated ``$PINT_TPU_HEALTH*``
  thresholds (``config.health_*``), feeds the registry gauges and
  histograms (``pint_tpu_health_*``), emits a ``health`` event under
  the enclosing dispatch span, and tracks the worst recent verdict per
  (pool, kind) for ``/healthz``.

- **incidents**: NaN/Inf, CG budget exhaustion, chi2 blow-up,
  residuals past the garbage threshold, or shadow drift beyond the band
  fire a rate-limited ``numerics:<reason>`` flight dump (the flight
  recorder's per-reason rate limit gives one dump per episode).

- **shadow-oracle drift sampling** (``$PINT_TPU_SHADOW_RATE``, default
  off): every Nth successful supervised dispatch of a shadow-capable
  key replays the completed solve on the numpy mirror in a BACKGROUND
  daemon thread and records device-vs-host drift in sigma as a
  registry histogram: the running answer to "does the card's float64
  still agree with the host". The scheduler is the supervisor's
  ``shadow=`` dispatch argument; this module owns the rate counter, the
  thread, the recording and the drift verdict.

Everything here is stdlib + numpy + the obs registry; the disarmed
path is one attribute read and a branch per observe. Histogram rows
are ``obs.hist`` log2-bucket rows, unit-agnostic: CG-iteration rows
count iterations in the "us" slot, drift rows record MICRO-SIGMA per
"us" (so a ``p99_ms`` readback is milli-sigma).
"""

from __future__ import annotations

import threading

from pint_tpu_torch.runtime import locks
import time
from typing import Callable, Dict, Optional, Tuple

__all__ = ["HealthMonitor", "get_monitor", "configure", "reset",
           "observe", "status", "drift_sigma"]


def drift_sigma(dev_x, dev_cov, mirror_x) -> float:
    """THE device-vs-mirror drift definition (in sigma of the DEVICE
    covariance; zero/invalid sigmas guard to 1.0 so a pinned column
    cannot divide-by-zero a verdict) — every shadow closure computes
    its drift through here, so the vocabulary has one tested home
    and the dense/streaming shadows can never diverge."""
    import numpy as np

    sig = np.sqrt(np.abs(np.diagonal(np.asarray(dev_cov))))
    sig = np.where(sig > 0, sig, 1.0)
    return float(np.max(
        np.abs(np.asarray(dev_x) - np.asarray(mirror_x)) / sig))

# incident taxonomy (the <reason> of numerics:<reason> flight dumps)
REASONS = ("nonfinite", "cg_budget", "chi2_blowup", "resid_sigma",
           "solver_not_ok", "drift")

# a bad (pool, kind) verdict sticks — degrading /healthz to 503 —
# until it is this old AND a newer good observation has landed: long
# enough that a flapping numerics episode stays visible to probes,
# bounded so one transient incident cannot evict a recovered worker
# forever (the breaker-cooldown shape)
_WORST_TTL_S = 300.0


def _nonfinite_count(vals) -> int:
    """Count non-finite entries across scalars/arrays — the ONE
    place host-side non-finite math for health lives."""
    import numpy as np

    n = 0
    for v in vals:
        if v is None:
            continue
        a = np.asarray(v)
        if a.dtype.kind not in "fc":
            continue
        n += int(a.size - np.count_nonzero(np.isfinite(a)))
    return n


class HealthMonitor:
    """Process numerical-health evaluator (module docstring).

    One instance per process (``get_monitor``); ``obs.reset()``
    drops it with the tracer/registry so a configured monitor never
    leaks across tests. All counters/gauges are bound children of
    the process metric registry, so ``status()`` is a derived view
    (the registry-vs-snapshot parity discipline)."""

    def __init__(self, enabled: Optional[bool] = None,
                 shadow_rate: Optional[int] = None):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        self.enabled = config.health_enabled(enabled)
        self.shadow_rate = config.shadow_rate() \
            if shadow_rate is None else max(0, int(shadow_rate))
        self.chi2_factor = config.health_chi2_factor()
        self.resid_band = config.health_resid_sigma()
        self.cg_frac = config.health_cg_budget_frac()
        self._lock = locks.make_lock("obs.health")
        self._shadow_seen: Dict[str, int] = {}
        self._worst: Dict[Tuple[str, str], dict] = {}
        self.last_incident: Optional[dict] = None
        self._c_incidents = om.counter(
            "pint_tpu_health_incidents_total",
            "numerical-health incidents by (kind, reason)")
        self._c_shadow = om.counter(
            "pint_tpu_health_shadow_replays_total",
            "shadow-oracle background replays")
        self._c_drift_exceeded = om.counter(
            "pint_tpu_health_shadow_drift_exceeded_total",
            "shadow replays whose drift exceeded the band")
        self._c_cg_exhausted = om.counter(
            "pint_tpu_health_cg_budget_exhausted_total",
            "CG solves that hit their iteration budget")
        self._g_last = om.gauge(
            "pint_tpu_health_last_value",
            "last observed health signal per (kind, signal)")
        self._h_cg = om.histogram(
            "pint_tpu_health_cg_iters",
            "CG iterations used (log2 buckets, unit = iterations)")
        self._h_drift = om.histogram(
            "pint_tpu_health_drift_sigma",
            "device-vs-host shadow drift (log2 buckets, unit = "
            "MICRO-sigma; p99_ms readback = milli-sigma)")

    @property
    def drift_band(self) -> float:
        """Re-resolved per read, not cached at construction: an
        environment change ($PINT_TPU_HEALTH_DRIFT_SIGMA) takes effect
        without rebuilding the monitor. Drift observations are rare
        (1-in-N background replays), so the re-read costs nothing that
        matters."""
        from pint_tpu_torch import config

        return config.health_drift_sigma()

    # -- the tap consumer ---------------------------------------------

    def observe(self, kind: str, signals: dict, *,
                pool: str = "device", key: Optional[str] = None) -> dict:
        """Evaluate one kernel's health signals; returns the verdict
        ``{"ok": bool, "reasons": [...], "checked": bool}``.

        ``signals`` is a dict of named taps — recognized keys:

        - ``hv``: the in-trace vector of the fit kernels,
          ``[nonfinite_count, max_resid_sigma, chi2]``;
        - ``values``: iterable of host scalars/arrays whose
          non-finite count is taken here (the injected-NaN readback
          check on already-returned outputs — zero extra dispatches);
        - ``chi2`` / ``chi2_prev``: blow-up detection;
        - ``cg_iters`` / ``cg_budget`` / ``cg_rel_residual`` /
          ``ok``: solver-effort and solver-verdict taps;
        - ``max_resid_sigma``, ``rescale``, ``accept_frac``,
          ``drift_sigma``: recorded + thresholded where a band
          exists.

        Disarmed, this returns immediately (one branch) and records
        NOTHING — the off-path zero-record contract. Exception: a
        ``drift_sigma`` observation is armed by the SHADOW rate
        alone — $PINT_TPU_SHADOW_RATE without $PINT_TPU_HEALTH is a
        documented configuration (drift sampling only), and a replay
        whose drift silently vanished would burn host CPU for
        nothing."""
        if not self.enabled and not (
                self.shadow_rate and "drift_sigma" in signals):
            return {"ok": True, "checked": False}
        import math

        import numpy as np

        vals: dict = {}
        reasons = []
        hv = signals.get("hv")
        if hv is not None:
            a = np.asarray(hv, dtype=np.float64).reshape(-1)
            vals["nonfinite"] = 0 if math.isfinite(float(a[0])) \
                else 1
            if math.isfinite(float(a[0])):
                vals["nonfinite"] = int(a[0])
            if a.size > 1:
                vals["max_resid_sigma"] = float(a[1])
            if a.size > 2 and "chi2" not in signals:
                vals["chi2"] = float(a[2])
            if a.size > 3 and "cg_rel_residual" not in signals:
                # slot 3 (the dense-solve hv): relative residual of
                # the direct solve — same gauge family as CG's
                vals["cg_rel_residual"] = float(a[3])
        if "values" in signals:
            vals["nonfinite"] = vals.get("nonfinite", 0) + \
                _nonfinite_count(signals["values"])
        if signals.get("nonfinite") is not None:
            # a precomputed in-trace count (the streaming chunk tap)
            pre = float(np.asarray(signals["nonfinite"]))
            vals["nonfinite"] = vals.get("nonfinite", 0) + \
                (int(pre) if math.isfinite(pre) else 1)
        if "lnpost" in signals:
            # walker log-posteriors: -inf is a LEGAL value (a walker
            # parked in a zero-probability region until its first
            # accepted move — the sampler only requires SOME finite
            # walker), so only NaN/+inf count as numerics garbage
            a = np.asarray(signals["lnpost"])
            vals["nonfinite"] = vals.get("nonfinite", 0) + \
                int(np.isnan(a).sum() + np.isposinf(a).sum())
        for name in ("chi2", "chi2_prev", "cg_iters", "cg_budget",
                     "cg_rel_residual", "max_resid_sigma",
                     "rescale", "accept_frac", "drift_sigma"):
            if signals.get(name) is not None:
                vals[name] = float(np.asarray(signals[name]))
        ok_flag = signals.get("ok")

        nf = vals.get("nonfinite", 0)
        if nf and not math.isfinite(float(nf)):
            nf = 1
        nf = int(nf)
        vals["nonfinite"] = nf
        if nf > 0:
            reasons.append("nonfinite")
        chi2 = vals.get("chi2")
        if chi2 is not None and not math.isfinite(chi2):
            if "nonfinite" not in reasons:
                reasons.append("nonfinite")
        prev = vals.get("chi2_prev")
        if chi2 is not None and prev is not None and \
                math.isfinite(chi2) and math.isfinite(prev) and \
                prev > 0 and chi2 > self.chi2_factor * prev:
            reasons.append("chi2_blowup")
        mrs = vals.get("max_resid_sigma")
        if mrs is not None and (not math.isfinite(mrs)
                                or mrs > self.resid_band):
            if math.isfinite(mrs) or nf == 0:
                reasons.append("resid_sigma" if math.isfinite(mrs)
                               else "nonfinite")
        iters = vals.get("cg_iters")
        budget = vals.get("cg_budget")
        if iters is not None:
            if math.isfinite(iters):
                self._h_cg.row(kind=kind).record(iters * 1e-6)
            if budget is not None and budget > 0 and \
                    iters >= self.cg_frac * budget:
                self._c_cg_exhausted.inc(kind=kind)
                reasons.append("cg_budget")
        if ok_flag is not None and not bool(np.asarray(ok_flag)):
            reasons.append("solver_not_ok")
        drift = vals.get("drift_sigma")
        if drift is not None:
            # finiteness BEFORE the histogram: a non-finite drift is
            # exactly the failure the shadow exists to catch, and it
            # must land as an incident, not as an OverflowError
            # inside the log2 bucketing that kills the verdict
            if math.isfinite(drift):
                self._h_drift.row(kind=kind).record(drift)
            if not math.isfinite(drift) or drift > self.drift_band:
                self._c_drift_exceeded.inc(kind=kind)
                reasons.append("drift")
        # de-dup, first reason is the headline
        seen: list = []
        for r in reasons:
            if r not in seen:
                seen.append(r)
        reasons = seen
        for name, v in vals.items():
            if name in ("nonfinite", "chi2", "chi2_prev",
                        "max_resid_sigma", "cg_iters",
                        "cg_rel_residual", "rescale",
                        "accept_frac", "drift_sigma") and \
                    math.isfinite(float(v)):
                self._g_last.set(float(v), kind=kind, signal=name)
        verdict = {"ok": not reasons, "reasons": reasons,
                   "checked": True}
        self._note_verdict(pool, kind, verdict)
        from pint_tpu_torch import obs

        obs.event("health", kind=kind, pool=pool, key=key,
                  ok=not reasons,
                  reasons=",".join(reasons) if reasons else None,
                  **{k: round(float(v), 6) for k, v in vals.items()
                     if math.isfinite(float(v))})
        if reasons:
            self._incident(kind, reasons[0], pool=pool, key=key,
                           signals=vals, reasons=reasons)
        return verdict

    # -- shadow-oracle sampling ---------------------------------------

    def shadow_due(self, key: str) -> bool:
        """Deterministic 1-in-N gate per dispatch key (the
        supervisor's shadow scheduler consults this on every
        successful shadow-capable dispatch). The FIRST eligible
        dispatch per key replays (a session that never reaches N
        dispatches still produces drift evidence)."""
        if not self.shadow_rate:
            return False
        with self._lock:
            n = self._shadow_seen.get(key, 0)
            self._shadow_seen[key] = n + 1
        return n % self.shadow_rate == 0

    def shadow_replay(self, kind: str, key: str,
                      fn: Callable[[], Optional[float]],
                      wait: bool = False):
        """Run one shadow replay — ``fn`` re-solves on the numpy
        mirror and returns device-vs-host drift in sigma (None =
        mirror not applicable). Background daemon thread by default
        (the production path must never serialize a dispatch behind
        a host replay); ``wait=True`` is the deterministic test
        mode. Never raises: a broken mirror is counted and logged,
        not a new failure mode on the hot path."""

        def work():
            try:
                drift = fn()
            except Exception as e:
                try:
                    from pint_tpu_torch.logging import log

                    log.warning("shadow replay (%s) failed: %r",
                                key, e)
                except Exception:
                    pass
                # a replay that RAN and died still counts: pollers
                # (bench, the capture stage) wait on this counter —
                # without it a broken mirror stalls them to timeout
                self._c_shadow.inc(kind=kind)
                return
            if drift is not None:
                self.observe(kind, {"drift_sigma": float(drift)},
                             pool="shadow", key=key)
            # counted AFTER the observation lands: pollers (bench,
            # the capture stage, tests) wait on this counter and
            # then read the drift histogram — incrementing first
            # would open a gap where the replay "happened" but its
            # sample is not yet visible
            self._c_shadow.inc(kind=kind)

        if wait:
            work()
            return None
        t = threading.Thread(target=work, daemon=True,
                             name=f"pint-shadow-{kind}")
        t.start()
        return t

    # -- incidents / reporting ----------------------------------------

    def _note_verdict(self, pool: str, kind: str, verdict: dict):
        now = time.monotonic()
        with self._lock:
            cur = self._worst.get((pool, kind))
            rec = {"ok": verdict["ok"],
                   "reasons": list(verdict["reasons"]), "t": now}
            # "worst RECENT": a bad verdict sticks through good
            # observations until it has aged past the TTL — then the
            # next good observation clears it (so a transient
            # incident degrades /healthz for at most ~TTL, never for
            # the life of the process), while a bad verdict with no
            # later good evidence stays visible indefinitely
            if cur is None or not verdict["ok"] or cur["ok"] or \
                    now - cur["t"] >= _WORST_TTL_S:
                self._worst[(pool, kind)] = rec
            else:
                cur["last_good_t"] = rec["t"]

    def _incident(self, kind: str, reason: str, pool: str,
                  key: Optional[str], signals: dict, reasons: list):
        import math

        self._c_incidents.inc(kind=kind, reason=reason)
        with self._lock:
            self.last_incident = {"kind": kind, "reason": reason,
                                  "reasons": list(reasons),
                                  "pool": pool, "key": key,
                                  "t": time.monotonic()}
        from pint_tpu_torch import obs

        obs.event("health.incident", kind=kind, reason=reason,
                  pool=pool, key=key)
        # rate-limited per reason by the FlightRecorder itself —
        # a NaN storm writes one dump per min_interval_s, not one
        # per dispatch
        obs.flight_dump(
            f"numerics:{reason}", kind=kind, pool=pool, key=key,
            signals={k: (float(v) if math.isfinite(float(v))
                         else repr(float(v)))
                     for k, v in signals.items()})
        try:
            from pint_tpu_torch.logging import log

            log.warning("numerical-health incident %s at %s/%s "
                        "(pool %s): %s", reason, kind, key, pool,
                        {k: float(v) for k, v in signals.items()})
        except Exception:
            pass

    def status(self) -> dict:
        """The ``health`` block serve snapshots / healthz / stats
        embed: worst recent verdict per (pool, kind), last incident
        reason + age, counters — all derived from registry children
        + the monitor's own lock (NEVER an engine lock)."""
        now = time.monotonic()
        with self._lock:
            worst = {}
            for (pool, kind), rec in sorted(self._worst.items()):
                e = {"ok": rec["ok"], "reasons": rec["reasons"],
                     "age_s": round(now - rec["t"], 3)}
                if rec.get("last_good_t") is not None:
                    # a bad verdict with later good evidence: still
                    # inside the TTL window, recovery in progress
                    e["last_good_age_s"] = round(
                        now - rec["last_good_t"], 3)
                worst[f"{pool}/{kind}"] = e
            li = None
            if self.last_incident is not None:
                li = {k: v for k, v in self.last_incident.items()
                      if k != "t"}
                li["age_s"] = round(now - self.last_incident["t"], 3)
        out = {
            "armed": self.enabled,
            "shadow_rate": self.shadow_rate,
            "drift_band_sigma": self.drift_band,
            "incidents": int(self._c_incidents.total()),
            "shadow_replays": int(self._c_shadow.total()),
            "shadow_drift_exceeded":
                int(self._c_drift_exceeded.total()),
            "cg_budget_exhausted": int(self._c_cg_exhausted.total()),
            "worst": worst,
            "last_incident": li,
        }
        drift_rows = self._h_drift.rows()
        if drift_rows:
            # micro-sigma buckets: p99_ms readback = milli-sigma
            out["drift"] = {
                "/".join(v for _, v in k) or "_": h.snapshot()
                for k, h in drift_rows}
        cg_rows = self._h_cg.rows()
        if cg_rows:
            out["cg_iters"] = {
                "/".join(v for _, v in k) or "_": h.snapshot()
                for k, h in cg_rows}
        return out


# ------------------------------------------------------------------
# the process-global monitor (armed by env, like the tracer)
# ------------------------------------------------------------------

_MON: Optional[HealthMonitor] = None
_LOCK = locks.make_lock("obs.health_global")


def get_monitor() -> HealthMonitor:
    global _MON
    if _MON is None:
        with _LOCK:
            if _MON is None:
                _MON = HealthMonitor()
    return _MON


def configure(enabled: Optional[bool] = None,
              shadow_rate: Optional[int] = None) -> HealthMonitor:
    """Explicitly (re)build the global monitor (tests, the bench
    armed leg). Omitted arguments fall back to env/config."""
    global _MON
    with _LOCK:
        _MON = HealthMonitor(enabled=enabled,
                             shadow_rate=shadow_rate)
        return _MON


def reset():
    """Drop the global monitor; the next use re-reads the env (the
    ``obs.reset()`` isolation contract — obs.reset calls this)."""
    global _MON
    with _LOCK:
        _MON = None


def observe(kind: str, signals: dict, *, pool: str = "device",
            key: Optional[str] = None) -> dict:
    """Module-level convenience: ``get_monitor().observe(...)`` —
    THE instrumentation surface call sites use."""
    m = _MON
    if m is None:
        m = get_monitor()
    if not m.enabled:   # one attribute read + branch when disarmed
        return {"ok": True, "checked": False}
    return m.observe(kind, signals, pool=pool, key=key)


def status() -> Optional[dict]:
    """The ``health`` block, or None when the monitor is not armed
    (keeps pre-health snapshot shapes bit-compatible). An armed env
    with no observation yet still reports the (empty) block — the
    monitor is built on demand, so a freshly started daemon's first
    ``stats`` answer already says "armed, zero incidents" instead
    of null."""
    m = _MON
    if m is None:
        from pint_tpu_torch import config

        if not (config.health_enabled() or config.shadow_rate()):
            return None
        m = get_monitor()
    if not (m.enabled or m.shadow_rate):
        return None
    return m.status()
