"""SLO burn-rate watchdog: declarative objectives over the metrics
registry, multi-window error-budget detection, flight-recorder fire (a
copy of pint_tpu/obs/slo.py, imports rewritten; the specs, windows and
metric names are the reference's).

Nothing watched the counters over time before this module: a latency
regression or shed creep surfaced only when a breaker opened or a
human read a bench artifact. The watchdog closes that gap with the
classic SRE multi-window burn-rate recipe:

- a **self-sampling ring**: every ``$PINT_TPU_SLO_INTERVAL_S`` the
  watchdog snapshots each SLO's raw cumulative state (histogram
  bucket counts, counter totals, gauge values) into a bounded deque
  — windowed rates are DELTAS between ring samples, so the registry
  stays cumulative-only and the ring is O(slow_window / interval);
- **burn rate** = (error rate over a window) / (the error budget the
  objective leaves). An SLO fires only when the FAST window and the
  SLOW window both burn past the spec's threshold — a one-sample
  spike inflates the fast window but not the slow one, and a stale
  regression burns the slow window while the fast one has recovered;
  neither alone fires (the no-false-fire contract of the tests);
- on fire, the **flight recorder** dumps with reason
  ``slo_burn:<name>`` — the post-mortem black box is written while
  the regression is happening, BEFORE the breaker-open dump the
  failure may eventually escalate to. One fire per burn episode
  (latched until the fast window recovers; the recorder additionally
  rate-limits per reason).

Three SLI types (``type`` in a spec dict):

- ``latency``: good = samples at/under ``objective_ms`` in a
  registry histogram's delta buckets (upper-edge attribution — the
  same one-octave conservative bound as every quantile in
  ``obs.hist``); ``target`` is the good fraction (0.99 = "p99 under
  objective");
- ``ratio``: error rate = delta(``bad`` counters) /
  delta(``total`` counters) against an allowed ``budget`` (the
  shed-rate SLO);
- ``gauge``: error rate = fraction of window samples where the gauge
  exceeds ``objective`` against ``budget`` (the dispatch
  ``overhead_frac`` SLO — fed wherever a pure-step-vs-wall
  measurement exists).

Off by default; ``$PINT_TPU_SLO`` arms it (truthy = the default spec
set; inline JSON or a JSON file path = custom specs). All env
parsing goes through validated ``config`` accessors per the
``dispatch_rtt_override_ms`` convention — a typo warns and is
ignored, never silently mis-arms a watchdog. Pure stdlib.
"""

from __future__ import annotations

import collections
import threading

from pint_tpu_torch.runtime import locks
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pint_tpu_torch.obs import metrics as om

__all__ = ["SLOSpec", "SLOWatchdog", "default_specs", "get_watchdog",
           "maybe_start", "status", "reset"]


@dataclass
class SLOSpec:
    name: str
    type: str                       # latency | ratio | gauge
    metric: str = ""                # latency/gauge source
    labels: Dict[str, str] = field(default_factory=dict)
    bad: List[str] = field(default_factory=list)    # ratio numerator
    total: List[str] = field(default_factory=list)  # ratio denom
    objective_ms: float = 1000.0    # latency threshold
    target: float = 0.99            # latency good-fraction objective
    objective: float = 0.1          # gauge threshold
    budget: float = 0.05            # ratio/gauge error budget
    fast_s: float = 60.0
    slow_s: float = 300.0
    burn: float = 2.0               # fire when BOTH windows >= this
    min_events: int = 4             # latency/ratio: delta floor
    min_samples: int = 2            # ring samples inside fast window

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        """Validated construction — raises ValueError on a spec that
        cannot be evaluated (config.slo_specs warns and drops it)."""
        if not isinstance(d, dict) or not d.get("name") \
                or d.get("type") not in ("latency", "ratio", "gauge"):
            raise ValueError(f"invalid SLO spec {d!r}")
        known = {f for f in cls.__dataclass_fields__}
        kw = {k: v for k, v in d.items() if k in known}
        spec = cls(**kw)
        if spec.type in ("latency", "gauge") and not spec.metric:
            raise ValueError(f"SLO {spec.name!r}: metric required")
        if spec.type == "ratio" and not (spec.bad and spec.total):
            raise ValueError(f"SLO {spec.name!r}: bad+total required")
        for fname in ("fast_s", "slow_s", "burn", "budget"):
            v = float(getattr(spec, fname))
            if not v > 0.0:
                raise ValueError(
                    f"SLO {spec.name!r}: {fname} must be > 0")
        if not 0.0 < float(spec.target) < 1.0:
            raise ValueError(f"SLO {spec.name!r}: target in (0,1)")
        return spec


def default_specs() -> List[SLOSpec]:
    """The armed-by-truthy-$PINT_TPU_SLO set: e2e p99 per serve kind,
    overall shed rate, dispatch overhead_frac."""
    specs = [
        SLOSpec(name=f"e2e_p99_{kind}", type="latency",
                metric="pint_tpu_serve_latency_seconds",
                labels={"metric": "e2e", "kind": kind},
                objective_ms=1000.0, target=0.99)
        for kind in ("gls", "phase", "posterior")
    ]
    specs.append(SLOSpec(
        name="shed_rate", type="ratio",
        bad=["pint_tpu_serve_shed_total"],
        # attempts, not submitted: quota/overload sheds never reach
        # the submitted counter, and a 100%-shed storm with a
        # flat denominator would evaluate to None instead of firing
        total=["pint_tpu_serve_attempts_total"],
        budget=0.05))
    specs.append(SLOSpec(
        name="dispatch_overhead", type="gauge",
        metric="pint_tpu_dispatch_overhead_frac",
        objective=0.1, budget=0.5))
    # numerical-health incident rate against the dispatch
    # volume — a sustained numerics episode (NaN storms, CG budget
    # exhaustion, drift beyond band) burns this budget and fires the
    # slo_burn flight dump on top of the per-incident numerics:<...>
    # dumps, the same escalation shape as shed_rate
    specs.append(SLOSpec(
        name="numerics_incident_rate", type="ratio",
        bad=["pint_tpu_health_incidents_total"],
        total=["pint_tpu_dispatch_dispatches_total"],
        budget=0.01))
    return specs


class SLOWatchdog:
    """Module docstring. ``tick()`` is the public sampling step —
    the daemon thread calls it on the interval; tests call it
    directly with an injected ``now`` for determinism."""

    def __init__(self, specs: Optional[List[SLOSpec]] = None,
                 interval_s: Optional[float] = None,
                 registry=None, clock=time.monotonic):
        from pint_tpu_torch import config

        self.specs = list(specs if specs is not None
                          else config.slo_specs())
        self.interval_s = float(config.slo_interval_s()
                                if interval_s is None else interval_s)
        self.registry = registry or om.get_registry()
        self.clock = clock
        slow = max((s.slow_s for s in self.specs), default=300.0)
        cap = int(min(4096, max(16, slow / max(self.interval_s, 1e-3)
                                + 4)))
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._burning: set = set()
        self._lock = locks.make_lock("obs.slo")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fires = 0
        self.ticks = 0
        self.last_fired: Optional[str] = None

    # -- sampling ------------------------------------------------------

    def _observe(self, spec: SLOSpec) -> dict:
        reg = self.registry
        if spec.type == "latency":
            m = reg.get(spec.metric)
            counts: Dict[int, int] = {}
            total = 0
            if m is not None and hasattr(m, "matching"):
                for h in m.matching(spec.labels):
                    with h._lock:
                        total += h.count
                        for k, v in h.counts.items():
                            counts[k] = counts.get(k, 0) + v
            return {"counts": counts, "count": total}
        if spec.type == "ratio":
            return {"bad": sum(reg.total(n) for n in spec.bad),
                    "total": sum(reg.total(n) for n in spec.total)}
        m = reg.get(spec.metric)
        vals = [v for _, v in m.series()] if m is not None else []
        return {"value": max(vals) if vals else None}

    def tick(self, now: Optional[float] = None) -> List[str]:
        """Take one sample, evaluate every spec, fire burns.
        Returns the names that fired THIS tick."""
        now = self.clock() if now is None else now
        sample = {"_t": now}
        for spec in self.specs:
            sample[spec.name] = self._observe(spec)
        om.sample_device_memory()
        fired: List[str] = []
        with self._lock:
            self._ring.append(sample)
            self.ticks += 1
            for spec in self.specs:
                fb = self._burn(spec, spec.fast_s, sample, now)
                sb = self._burn(spec, spec.slow_s, sample, now)
                if fb is None or sb is None:
                    continue
                if fb >= spec.burn and sb >= spec.burn:
                    if spec.name not in self._burning:
                        self._burning.add(spec.name)
                        self.fires += 1
                        self.last_fired = spec.name
                        fired.append(spec.name)
                elif fb < spec.burn:
                    # the episode ends when the FAST window recovers
                    self._burning.discard(spec.name)
        for name in fired:
            spec = next(s for s in self.specs if s.name == name)
            from pint_tpu_torch import obs

            obs.event("slo.burn", slo=name)
            fpath = obs.flight_dump(f"slo_burn:{name}",
                                    slo=self._spec_status(spec, now))
            # automatic one-shot profiler window on the
            # burn — capture the dispatches of the regression WHILE
            # it is happening, cross-linked to this episode's flight
            # dump. One per episode: the watchdog only fires once
            # per burn episode (latched above) and the profiler
            # additionally rate-limits per reason. Never raises.
            from pint_tpu_torch.obs import perf as _perf

            _perf.auto_window(f"slo_burn:{name}", slo=name,
                              flight=fpath)
        return fired

    def _window_base(self, window_s: float, now: float):
        """Latest ring sample at/older than the window start — the
        delta baseline. None until the ring actually SPANS the
        window (an uncovered window must not fire: that is exactly
        the one-sample-spike false positive)."""
        base = None
        for s in self._ring:
            if s["_t"] <= now - window_s:
                base = s
            else:
                break
        return base

    def _burn(self, spec: SLOSpec, window_s: float, cur: dict,
              now: float) -> Optional[float]:
        base = self._window_base(window_s, now)
        if base is None:
            return None
        n_in = sum(1 for s in self._ring
                   if now - window_s < s["_t"] <= now)
        if n_in < spec.min_samples:
            return None
        a, b = base.get(spec.name), cur.get(spec.name)
        if a is None or b is None:
            return None
        if spec.type == "latency":
            d_total = b["count"] - a["count"]
            if d_total < spec.min_events:
                return None
            good = 0
            for k in b["counts"]:
                d = b["counts"].get(k, 0) - a["counts"].get(k, 0)
                le_us = (1 << k) if k else 1
                if le_us <= spec.objective_ms * 1e3:
                    good += d
            err = 1.0 - good / d_total
            return err / max(1e-9, 1.0 - spec.target)
        if spec.type == "ratio":
            d_total = b["total"] - a["total"]
            if d_total < spec.min_events:
                return None
            err = max(0.0, (b["bad"] - a["bad"])) / d_total
            return err / max(1e-9, spec.budget)
        # gauge: violation fraction over the window's samples
        vals = [s[spec.name]["value"] for s in self._ring
                if now - window_s < s["_t"] <= now
                and s.get(spec.name, {}).get("value") is not None]
        if not vals:
            return None
        frac = sum(1 for v in vals if v > spec.objective) / len(vals)
        return frac / max(1e-9, spec.budget)

    # -- reporting -----------------------------------------------------

    def _spec_status(self, spec: SLOSpec, now: float) -> dict:
        cur = self._ring[-1] if self._ring else {"_t": now}
        out = {"name": spec.name, "type": spec.type,
               "burn_threshold": spec.burn,
               "fast_s": spec.fast_s, "slow_s": spec.slow_s}
        for label, w in (("fast_burn", spec.fast_s),
                         ("slow_burn", spec.slow_s)):
            b = self._burn(spec, w, cur, cur["_t"])
            out[label] = None if b is None else round(b, 3)
        out["burning"] = spec.name in self._burning
        return out

    def status(self) -> dict:
        """The ``slo`` block serve snapshots / healthz embed."""
        with self._lock:
            now = self._ring[-1]["_t"] if self._ring \
                else self.clock()
            return {
                "armed": True,
                "interval_s": self.interval_s,
                "ticks": self.ticks,
                "fires": self.fires,
                "last_fired": self.last_fired,
                "specs": [self._spec_status(s, now)
                          for s in self.specs],
            }

    # -- the sampling thread -------------------------------------------

    def start(self) -> "SLOWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pint-slo")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a broken spec must not kill sampling
                pass


# ------------------------------------------------------------------
# process-global instance (armed by env, like the tracer)
# ------------------------------------------------------------------

_WATCHDOG: Optional[SLOWatchdog] = None
_LOCK = locks.make_lock("obs.slo_global")


def get_watchdog() -> Optional[SLOWatchdog]:
    return _WATCHDOG


def maybe_start() -> Optional[SLOWatchdog]:
    """Arm-and-start from the env ($PINT_TPU_SLO); no-op (returns
    None) when unarmed. Idempotent."""
    global _WATCHDOG
    from pint_tpu_torch import config

    if not config.slo_enabled():
        return None
    with _LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = SLOWatchdog().start()
        return _WATCHDOG


def status() -> Optional[dict]:
    w = _WATCHDOG
    return w.status() if w is not None else None


def reset():
    """Stop + drop the global watchdog (test isolation, with
    obs.reset)."""
    global _WATCHDOG
    with _LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
        _WATCHDOG = None
