"""Breaker-aware capacity routing: host CPU and accelerator as
CONCURRENT pools with learned service rates.

A port of pint_tpu/serve/router.py (host code, copied). The host is a
first-class capacity pool, not only the dispatch supervisor's failover
target:

- **N named pools**: "device" (the
  engine's batched torch programs on its device, "cuda:0" by default)
  and "host" (the numpy mirrors — ``pta_solve_np`` /
  ``PolycoEntry.abs_phase`` — running pinned, hang-free, on the
  caller's CPU) are structural; ``$PINT_TPU_POOLS`` adds further
  device-class pools, each with its own breaker, rates and
  counters. In a pipelined drain, units routed to different pools
  genuinely execute concurrently.
- **learned service rates**: every completed dispatch feeds an EWMA
  of rows/s per (pool, kind). Rows are KIND-LOCAL units (padded
  TOA/MJD rows for gls/phase, walker-steps for posterior chains), so
  backlogs are tracked and costed per kind — a queued posterior unit
  is priced at the posterior rate in every completion-time and
  admission-wait estimate, never at the GLS
  rate. Routing predicts each pool's completion time as the per-kind
  backlog cost + this batch / rate and picks the cheaper pool. Cold start is deliberately conservative:
  until the HOST rate has been observed (a breaker demotion served
  there, or ``seed_rate`` taught it explicitly), everything routes
  to the device — the router never guesses the host faster on no
  evidence, so a fault-free deployment behaves exactly like the
  pre-router engine.
- **breaker-aware demotion**: an OPEN device breaker
  (``runtime.breaker``, consulted through the supervisor's
  ``pool_health`` surface) demotes the device pool instead of
  stopping the world — batches route straight to the host pool,
  counted as ``demotions``, without each paying the watchdog-timeout
  + failover dance first. When the breaker closes (half-open probe
  recovery), the device pool rejoins automatically.

Every decision is visible: ``snapshot()`` is the ``router`` block of
``ServeMetrics.snapshot()`` (per-pool dispatch/request/row shares,
learned rates, demotion count).
"""

from __future__ import annotations

from typing import Dict, Optional

from pint_tpu_torch.runtime import locks

__all__ = ["CapacityRouter"]

# EWMA smoothing for learned rates: ~5-dispatch memory — fast enough
# to track a warming cache, slow enough not to thrash on one outlier
_EWMA_ALPHA = 0.3
# rows/s assumed for a pool that has never been observed; the device
# prior is high on purpose (routing away from the device requires
# EVIDENCE, not a guess)
_DEVICE_PRIOR = 1e9


class _Pool:
    """One capacity pool's accounting. The monotonic
    counters (dispatches/requests/rows/demotions) are bound children
    of the registry's ``pint_tpu_router_*_total`` metrics labelled
    (scope, pool) and read back through ``__getattr__``; the learned
    EWMA rates and in-flight backlog mirror into gauges. Routing
    logic keeps its local ``rates``/``inflight_kind`` dicts — the
    registry is the observability plane, not the decision state."""

    _COUNTERS = ("dispatches", "requests", "rows", "demotions")

    __slots__ = ("name", "rates", "inflight_rows", "inflight_kind",
                 "_c", "_g_rate", "_g_inflight", "_scope")

    def __init__(self, name: str, scope: str = ""):
        from pint_tpu_torch.obs import metrics as om

        self.name = name
        self._scope = scope
        self._c = {
            cn: om.counter(
                f"pint_tpu_router_{cn}_total",
                f"capacity-router {cn} per pool"
            ).child(scope=scope, pool=name)
            for cn in self._COUNTERS}
        self._g_rate = om.gauge(
            "pint_tpu_router_rate_rows_per_s",
            "learned EWMA service rate per (pool, kind)")
        self._g_inflight = om.gauge(
            "pint_tpu_router_inflight_rows",
            "in-flight kind-local rows per pool"
        ).child(scope=scope, pool=name)
        self.rates: Dict[str, float] = {}   # kind -> EWMA rows/s
        self.inflight_rows = 0
        self.inflight_kind: Dict[str, int] = {}  # kind -> rows

    def __getattr__(self, name):
        # __slots__ class: _c exists once __init__ ran; counter
        # names read through the registry children
        if name in _Pool._COUNTERS:
            return int(object.__getattribute__(self, "_c")[name]
                       .value())
        raise AttributeError(name)

    def bump(self, counter: str, n: int = 1):
        self._c[counter].inc(n)

    def rate(self, kind: str) -> Optional[float]:
        return self.rates.get(kind)

    def observe(self, kind: str, rows: int, wall_s: float):
        if wall_s <= 0.0:
            return
        r = max(1.0, rows) / wall_s
        prev = self.rates.get(kind)
        self.rates[kind] = r if prev is None else \
            (1.0 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * r
        self._g_rate.set(self.rates[kind], scope=self._scope,
                         pool=self.name, kind=kind)

    def snapshot(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "requests": self.requests,
            "rows": self.rows,
            "inflight_rows": self.inflight_rows,
            "demotions": self.demotions,
            "rows_per_s": {k: round(v, 1)
                           for k, v in sorted(self.rates.items())},
        }

    def add_inflight(self, kind: str, rows: int):
        self.inflight_rows += rows
        self.inflight_kind[kind] = \
            self.inflight_kind.get(kind, 0) + rows
        self._g_inflight.set(self.inflight_rows)

    def sub_inflight(self, kind: str, rows: int):
        self.inflight_rows = max(0, self.inflight_rows - rows)
        self.inflight_kind[kind] = max(
            0, self.inflight_kind.get(kind, 0) - rows)
        self._g_inflight.set(self.inflight_rows)


class CapacityRouter:
    """Routes sealed shape-class units to a capacity pool.

    ``supervisor`` provides the ``pool_health`` surface (breaker
    state). One router per engine — its shares are that deployment's
    accounting, like the engine's compile counts.

    ``pools`` generalizes the capacity layer to N NAMED
    pools (default ``config.pool_spec()``, i.e. the classic
    ``("device", "host")`` pair): "device" and "host" stay
    structural — the engine's batched class programs and the always-
    available numpy mirrors — and every extra name is an additional
    device-class pool with its own process-global ``runtime.breaker``
    instance (keyed ``pool:<name>`` through the supervisor's
    ``pool_health`` surface), its own learned EWMA rates, and its own
    registry counters. An OPEN breaker demotes ONLY its pool;
    host demotion-of-last-resort happens only when every device-class
    pool is open. With the default spec the routing decisions are
    bit-identical to the two-pool router."""

    def __init__(self, supervisor=None, pools=None, device=None):
        from pint_tpu_torch import config
        from pint_tpu_torch.obs import metrics as om

        self.supervisor = supervisor
        # the engine's device: its breaker ("cuda:0", or "cpu") is the
        # device pool's health
        self.device = device
        self.scope = om.new_scope("router")
        if pools is None:
            pools = config.pool_spec() or ("device", "host")
        # stable routing order: device first (ties prefer it, the
        # two-pool behavior), extra device-class pools in spec
        # order, host last (the failover pool never wins a tie)
        names = ["device"]
        names += [n for n in pools if n not in ("device", "host")]
        names.append("host")
        self._order = tuple(names)
        self._extra = tuple(n for n in self._order
                            if n not in ("device", "host"))
        self.pools = {n: _Pool(n, scope=self.scope)
                      for n in self._order}
        self._lock = locks.make_lock("serve.router")

    # -- routing -------------------------------------------------------

    def _open_pools(self) -> dict:
        """Breaker-open flags per device-class pool (host is never
        open — definitionally closed). One ``pool_health`` read per
        routing decision, never a probe."""
        if self.supervisor is None:
            return {}
        try:
            h = self.supervisor.pool_health(pools=self._extra,
                                            device=self.device)
            return {n: bool(h.get(n, {}).get("open", False))
                    for n in self._order if n != "host"}
        except Exception:
            return {}

    def _device_open(self) -> bool:
        return self._open_pools().get("device", False)

    def pick(self, kind: str, rows: int) -> str:
        """Choose the pool for one sealed unit of ``rows`` padded
        rows. A breaker-open device-class pool is demoted outright
        (only when EVERY device-class pool is open does the unit
        route straight to host, counted as a demotion); otherwise
        the pool with the smaller predicted completion time wins,
        with device-class pools preferred until the host has a
        LEARNED rate."""
        with self._lock:
            host = self.pools["host"]
            open_map = self._open_pools()
            live = [n for n in self._order
                    if n != "host" and not open_map.get(n, False)]
            if not live:
                host.bump("demotions")
                return "host"

            def backlog_s(p, r_kind):
                # per-kind backlog costing (each kind at its own
                # learned rate; unlearned kinds free — consistent
                # with predicted_wait_s)
                t = 0.0
                for k, v in p.inflight_kind.items():
                    r = r_kind if k == kind else p.rate(k)
                    if r:
                        t += v / r
                return t

            best, best_t = None, None
            for n in live:
                p = self.pools[n]
                r = p.rate(kind) or _DEVICE_PRIOR
                t = backlog_s(p, r) + rows / r
                if best_t is None or t < best_t:
                    best, best_t = n, t
            hr = host.rate(kind)
            if hr is None:
                # cold host: routing away from the device classes
                # requires evidence, never a guess
                return best
            t_host = backlog_s(host, hr) + rows / hr
            return best if best_t <= t_host else "host"

    def _best_rate(self, kind: str) -> Optional[float]:
        rates = [p.rate(kind) for p in self.pools.values()]
        rates = [r for r in rates if r]
        return max(rates) if rates else None

    def predicted_wait_s(self, rows: int, kind: str = "gls",
                         ahead_by_kind: Optional[Dict[str, int]]
                         = None) -> float:
        """Admission-policy estimate: how long ``rows`` rows of
        ``kind`` would wait given the current backlog, PER-KIND: each kind's backlog — in-flight plus the
        caller-supplied queued-ahead ``ahead_by_kind`` — is costed at
        ITS OWN best learned (pool, kind) rate, so a posterior chain
        queued ahead is priced at the posterior rate, never the
        ~1000x faster GLS rate (which would admit a doomed long chain
        against a deadline it provably cannot make). Rows are
        kind-local units (padded TOA/MJD rows for gls/phase,
        walker-steps for posterior) — which is exactly why rates and
        backlogs must never mix across kinds. A kind with no learned
        rate contributes 0 (never doomed on no evidence); if the
        NEWCOMER's own kind is unlearned the whole estimate is 0."""
        with self._lock:
            own = self._best_rate(kind)
            if own is None:
                return 0.0
            backlog: Dict[str, int] = {}
            for p in self.pools.values():
                for k, v in p.inflight_kind.items():
                    backlog[k] = backlog.get(k, 0) + v
            for k, v in (ahead_by_kind or {}).items():
                backlog[k] = backlog.get(k, 0) + v
            t = rows / own
            for k, v in backlog.items():
                r = self._best_rate(k)
                if r:
                    t += v / r
            return t

    # -- accounting ----------------------------------------------------

    def issued(self, pool: str, nreq: int, rows: int,
               kind: str = "gls"):
        with self._lock:
            p = self.pools[pool]
            p.bump("dispatches")
            p.bump("requests", nreq)
            p.bump("rows", rows)
            p.add_inflight(kind, rows)

    def finished(self, pool: str, kind: str, rows: int,
                 wall_s: float, used_pool: Optional[str] = None):
        """Complete one dispatch issued to ``pool``. ``used_pool``
        names the pool that ACTUALLY produced the result; a rate is
        observed only when the result came from the pool it was
        issued to. A device-issued dispatch that failed over to the
        host ("host-failover") teaches NOBODY: its wall includes the
        watchdog deadline it first burned, a corrupt sample for
        either pool — the failover stays visible in the supervisor
        counters, and repeated failures trip the breaker whose OPEN
        state is what routes (and teaches) the host pool."""
        with self._lock:
            self.pools[pool].sub_inflight(kind, rows)
            if used_pool is None:
                used_pool = pool
            if used_pool == pool:
                self.pools[pool].observe(kind, rows, wall_s)

    def seed_rate(self, pool: str, kind: str, rows_per_s: float):
        """Directly set a pool's learned rate (tests, and the bench's
        host-probe warmup)."""
        with self._lock:
            p = self.pools[pool]
            p.rates[kind] = float(rows_per_s)
            p._g_rate.set(p.rates[kind], scope=self.scope,
                          pool=pool, kind=kind)

    def snapshot(self) -> dict:
        with self._lock:
            out = {name: p.snapshot()
                   for name, p in self.pools.items()}
        total = sum(p["dispatches"] for p in out.values())
        for p in out.values():
            p["share"] = round(p["dispatches"] / total, 4) \
                if total else 0.0
        return out

    def health_block(self) -> dict:
        """The /healthz ``pools`` block: per
        pool, the breaker state (through the supervisor's
        ``pool_health`` surface), the learned EWMA rates, and the
        in-flight depth. Engine-lock-free by construction — the only
        locks touched are the router's own leaf lock and the
        per-breaker locks, so the fleet front (and any scrape) can
        read it while the engine lock is held (the scrape
        contract tests/test_metrics.py asserts)."""
        try:
            health = self.supervisor.pool_health(
                pools=self._extra, device=self.device) \
                if self.supervisor is not None else {}
        except Exception:
            health = {}
        with self._lock:
            out = {}
            for name, p in self.pools.items():
                h = dict(health.get(name, {}))
                h["rows_per_s"] = {k: round(v, 1)
                                   for k, v in sorted(
                                       p.rates.items())}
                h["inflight_rows"] = p.inflight_rows
                out[name] = h
        return out
