"""The SLO burn-rate watchdog of the port (pint_tpu_torch.obs.slo) held to
the reference's pint_tpu.obs.slo on the CPU.

``test_shared_semantics`` runs the SLO cases of tests/test_metrics.py
(:96 and :453-590) through both packages, with injected clocks, and
holds the outcomes equal: which ticks fire, the latch, the flight dump
and its ``slo`` block, the ratio, gauge and latency specs, the config
parsers and ``maybe_start``. The :96 case drives each package's serve
engine (the port's on the CPU) through a storm of real quota sheds: a
storm of pure sheds must fire the default ``shed_rate`` spec, not
evaluate to None.
"""

import json
import types

import pytest

ENV = ("PINT_TPU_SLO", "PINT_TPU_SLO_INTERVAL_S", "PINT_TPU_FLIGHT_DIR",
       "PINT_TPU_TRACE", "PINT_TPU_PROFILE_DIR", "PINT_TPU_HEALTH")


def _ns(which):
    if which == "ref":
        import pint_tpu.config as cfg
        import pint_tpu.runtime as rt
        from pint_tpu import obs
        from pint_tpu.obs import metrics as om
        from pint_tpu.obs import slo
        from pint_tpu.serve import ServeEngine, TenantOverQuota
        from pint_tpu.serve.workload import build_workload
        kw = {}
    else:
        import pint_tpu_torch.config as cfg
        import pint_tpu_torch.runtime as rt
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import metrics as om
        from pint_tpu_torch.obs import slo
        from pint_tpu_torch.serve import ServeEngine, TenantOverQuota
        from pint_tpu_torch.serve.workload import build_workload
        kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=which, config=cfg, rt=rt, obs=obs, om=om, slo=slo,
        TenantOverQuota=TenantOverQuota,
        Engine=lambda **k: ServeEngine(**kw, **k),
        workload=lambda n, base: build_workload(
            n, sizes=(40, 90), base=base, prebuild=True,
            entry_name="METR", **kw))


def _reset(ns):
    ns.rt.reset_runtime()
    ns.obs.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for which in ("ref", "port"):
        _reset(_ns(which))
    yield
    for which in ("ref", "port"):
        _reset(_ns(which))


def _latency_spec(slo, **kw):
    base = dict(name="p99", type="latency", metric="syn_lat_seconds",
                labels={"metric": "e2e"}, objective_ms=8.192, target=0.9,
                fast_s=10.0, slow_s=30.0, burn=2.0, min_events=4,
                min_samples=2)
    base.update(kw)
    return slo.SLOSpec(**base)


# ------------------------------------------------------------ scenarios


def s_burn_rate_math(ns, mp, tmp):
    fdir = tmp / ns.name
    ns.obs.configure(enabled=False, flight_dir=str(fdir))
    reg = ns.om.get_registry()
    row = reg.histogram("syn_lat_seconds").row(metric="e2e", kind="gls")
    clock = {"t": 0.0}
    wd = ns.slo.SLOWatchdog(specs=[_latency_spec(ns.slo)], interval_s=5.0,
                            registry=reg, clock=lambda: clock["t"])

    def tick_with(good=0, bad=0):
        for _ in range(good):
            row.record(0.001)
        for _ in range(bad):
            row.record(0.5)
        fired = wd.tick(now=clock["t"])
        clock["t"] += 5.0
        return fired

    out = [tick_with(bad=10)]
    out += [tick_with(good=10) for _ in range(8)]
    out += [tick_with(bad=10), tick_with(good=10)]
    fired = []
    for _ in range(6):
        fired += tick_with(bad=10)
    assert fired == ["p99"]         # exactly once: latched
    out += [fired, wd.fires]
    dumps = sorted(fdir.glob("flight-*slo_burn*p99*.json"))
    doc = json.loads(dumps[0].read_text())
    out += [len(dumps), doc["reason"], doc["extra"]["slo"]]
    for _ in range(8):
        tick_with(good=10)
    for _ in range(6):
        tick_with(bad=10)
    st = wd.status()
    return out + [wd.fires, st["armed"], st["fires"], st["ticks"],
                  st["specs"], st["last_fired"]]


def s_ratio_and_gauge(ns, mp, tmp):
    reg = ns.om.get_registry()
    bad = reg.counter("syn_shed_total")
    tot = reg.counter("syn_submitted_total")
    g = reg.gauge("syn_overhead_frac")
    specs = [
        ns.slo.SLOSpec(name="shed", type="ratio", bad=["syn_shed_total"],
                       total=["syn_submitted_total"], budget=0.05,
                       fast_s=10.0, slow_s=20.0, burn=2.0, min_events=4),
        ns.slo.SLOSpec(name="overhead", type="gauge",
                       metric="syn_overhead_frac", objective=0.1,
                       budget=0.5, fast_s=10.0, slow_s=20.0, burn=1.5),
    ]
    clock = {"t": 0.0}
    wd = ns.slo.SLOWatchdog(specs=specs, interval_s=5.0, registry=reg,
                            clock=lambda: clock["t"])

    def tick(shed=0, total=0, frac=0.0):
        bad.inc(shed)
        tot.inc(total)
        g.set(frac)
        fired = wd.tick(now=clock["t"])
        clock["t"] += 5.0
        return fired

    out = [tick(shed=0, total=10, frac=0.02) for _ in range(6)]
    fired = []
    for _ in range(5):
        fired += tick(shed=5, total=10, frac=0.4)
    assert sorted(set(fired)) == ["overhead", "shed"]
    assert fired.count("shed") == 1
    return out + [fired, wd.status()["specs"]]


def s_shed_storm(ns, mp, tmp):
    spec = next(s for s in ns.slo.default_specs() if s.name == "shed_rate")
    spec.fast_s, spec.slow_s, spec.burn = 10.0, 30.0, 2.0
    clock = {"t": 0.0}
    wd = ns.slo.SLOWatchdog(specs=[spec], interval_s=5.0,
                            clock=lambda: clock["t"])
    fresh = ns.workload(2, base=6700)
    eng = ns.Engine(tenant_qps=1000.0, tenant_burst=100.0)

    def tick(noisy=False):
        for r in fresh():
            r.tenant = "noisy" if noisy else "calm"
            try:
                eng.submit(r)
            except ns.TenantOverQuota:
                pass
        eng.flush()
        fired = wd.tick(now=clock["t"])
        clock["t"] += 5.0
        return fired

    out = [tick() for _ in range(8)]
    # pure-shed storm: drain the noisy tenant's bucket every tick
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="serve.admit/noisy",
                                        kind="tenant_burst")])
    fired = []
    with plan.active():
        for _ in range(6):
            fired += tick(noisy=True)
    assert fired == ["shed_rate"]
    assert eng.metrics.attempts > eng.metrics.submitted
    return out + [fired, wd.fires, eng.metrics.attempts,
                  eng.metrics.submitted, eng.admission.shed_quota]


def s_default_specs_and_parsers(ns, mp, tmp):
    cfg = ns.config
    out = [cfg.slo_enabled(), cfg.slo_specs()]
    mp.setenv("PINT_TPU_SLO", "on")
    out += [cfg.slo_enabled(), [(s.name, s.type, s.metric, s.labels, s.bad,
                                 s.total, s.budget, s.objective)
                                for s in cfg.slo_specs()]]
    mp.setenv("PINT_TPU_SLO", json.dumps([
        {"name": "ok", "type": "ratio", "bad": ["a"], "total": ["b"]},
        {"name": "broken", "type": "latency"},
        {"type": "gauge", "metric": "m"},
        {"name": "bad_target", "type": "gauge", "metric": "m",
         "target": 1.5},
    ]))
    out.append([s.name for s in cfg.slo_specs()])
    spec_file = tmp / f"{ns.name}.json"
    spec_file.write_text(json.dumps({"name": "f", "type": "gauge",
                                     "metric": "m"}))
    mp.setenv("PINT_TPU_SLO", str(spec_file))
    out.append([s.name for s in cfg.slo_specs()])
    for v in ("/no/such/file.json", "[not json"):
        mp.setenv("PINT_TPU_SLO", v)
        out += [cfg.slo_specs(), cfg.slo_enabled()]
    for v in ("2.5", "-3", "banana"):
        mp.setenv("PINT_TPU_SLO_INTERVAL_S", v)
        out.append(cfg.slo_interval_s())
    return out


def s_maybe_start(ns, mp, tmp):
    out = [ns.slo.maybe_start(), ns.slo.status()]
    mp.setenv("PINT_TPU_SLO", "on")
    mp.setenv("PINT_TPU_SLO_INTERVAL_S", "60")
    w1 = ns.slo.maybe_start()
    w2 = ns.slo.maybe_start()
    out += [w1 is w2 is ns.slo.get_watchdog(), ns.slo.status()["armed"],
            ns.slo.status()["interval_s"],
            ns.om.default_health()["slo"]["armed"]]
    ns.slo.reset()
    return out + [ns.slo.get_watchdog(), "slo" in ns.om.default_health()]


def s_healthy_registry_never_burns(ns, mp, tmp):
    """The default specs over a registry with healthy dispatches: no
    window ever fires."""
    clock = {"t": 0.0}
    wd = ns.slo.SLOWatchdog(specs=ns.slo.default_specs(), interval_s=5.0,
                            clock=lambda: clock["t"])
    sup = ns.rt.DispatchSupervisor()
    fired = []
    for _ in range(12):
        for _ in range(4):
            sup.dispatch(lambda: 1.0, key="unit.ok")
        fired += wd.tick(now=clock["t"])
        clock["t"] += 5.0
    assert fired == [] and wd.ticks == 12
    return [fired, wd.fires, [(s["name"], s["burning"])
                              for s in wd.status()["specs"]]]


SHARED = {
    "test_slo_burn_rate_math_on_synthetic_series": s_burn_rate_math,
    "test_slo_ratio_and_gauge_specs": s_ratio_and_gauge,
    "test_shed_rate_slo_fires_on_pure_quota_shed_storm": s_shed_storm,
    "test_slo_default_specs_and_config_parsing":
        s_default_specs_and_parsers,
    "test_slo_maybe_start_idempotent": s_maybe_start,
    "healthy_registry_never_burns": s_healthy_registry_never_burns,
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_semantics(case, monkeypatch, tmp_path):
    got = {}
    for which in ("ref", "port"):
        ns = _ns(which)
        with monkeypatch.context() as mp:
            _reset(ns)
            got[which] = SHARED[case](ns, mp, tmp_path)
            _reset(ns)
    assert got["port"] == got["ref"]


def test_spec_validation():
    """``SLOSpec.from_dict`` refuses what cannot be evaluated (the
    parser's warn-and-drop relies on it)."""
    from pint_tpu_torch.obs.slo import SLOSpec

    for bad in ({"name": "x", "type": "nope"}, {"type": "ratio"},
                {"name": "x", "type": "gauge"},
                {"name": "x", "type": "ratio", "bad": ["a"]},
                {"name": "x", "type": "gauge", "metric": "m", "burn": 0},
                {"name": "x", "type": "gauge", "metric": "m",
                 "target": 1.0}, "not a dict"):
        with pytest.raises(ValueError):
            SLOSpec.from_dict(bad)
    s = SLOSpec.from_dict({"name": "x", "type": "latency", "metric": "m",
                           "ignored_key": 1})
    assert s.objective_ms == 1000.0 and s.target == 0.99


def test_watchdog_thread_starts_and_stops():
    """The sampling thread ticks on its interval and stops on reset."""
    import time

    from pint_tpu_torch.obs import slo

    wd = slo.SLOWatchdog(specs=slo.default_specs(), interval_s=0.05)
    wd.start()
    t0 = time.monotonic()
    while wd.ticks < 2 and time.monotonic() - t0 < 10.0:
        time.sleep(0.02)
    wd.stop()
    assert wd.ticks >= 2 and wd._thread is None
