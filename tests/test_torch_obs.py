"""The port's copy of the obs core (pint_tpu_torch.obs: tracer,
histograms, flight recorder, metric registry) held to the reference's
pint_tpu.obs on the CPU.

``test_shared_semantics`` has one case for each test of tests/test_obs.py
and tests/test_metrics.py that exercises the copied core (the serve,
SLO, health, perf and daemon cases belong to planes the port does not
have yet). Each case runs the same sequence of counter, gauge,
histogram, span and dispatch operations through both packages and holds
the outcomes equal: the ``render()`` text (scope ids aside: they are
process counters), the tracer records (timestamps, thread ids and span
ids aside; the parent links are compared as positions in the ring), the
histogram snapshots and the flight dump's keys.
"""

import json
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch


def _ns(which):
    if which == "ref":
        import pint_tpu.config as cfg
        import pint_tpu.runtime as rt
        from pint_tpu import obs
        from pint_tpu.obs import metrics as om
    else:
        import pint_tpu_torch.config as cfg
        import pint_tpu_torch.runtime as rt
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import metrics as om
    return types.SimpleNamespace(name=which, rt=rt, config=cfg, obs=obs,
                                 om=om)


def _reset(ns):
    # the runtime first: its reset rebuilds the global supervisor's
    # counters in the current registry, which obs.reset then replaces
    ns.rt.reset_runtime()
    ns.obs.reset()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("PINT_TPU_TRACE", "PINT_TPU_TRACE_STREAM",
                 "PINT_TPU_TRACE_RING", "PINT_TPU_FLIGHT_DIR",
                 "PINT_TPU_DISPATCH_RTT_MS"):
        monkeypatch.delenv(name, raising=False)
    for which in ("ref", "port"):
        _reset(_ns(which))
    yield
    for which in ("ref", "port"):
        _reset(_ns(which))


_SCOPE = re.compile(r'scope="[a-z]+\d+"')


def _render(ns):
    return _SCOPE.sub('scope="S"', ns.om.render())


def _records(recs):
    """Tracer records without timestamps, threads or ids: the parent
    link as the position of the parent's record (None for a root)."""
    pos = {r["args"]["span"]: i for i, r in enumerate(recs)}
    out = []
    for r in recs:
        args = {k: v for k, v in r["args"].items()
                if k not in ("trace", "span", "parent", "error")}
        out.append((r["name"], r["ph"], sorted(args.items()),
                    pos.get(r["args"].get("parent"))))
    return out


# ------------------------------------------------------------ scenarios


def s_span_nesting(ns, mp, tmp):
    obs = ns.obs
    t = obs.configure(enabled=True)
    with obs.span("root", kind="test") as root:
        root.event("marker", x=1)
        with obs.span("child") as child:
            same = (child.trace_id == root.trace_id,
                    obs.current() == child.ctx)
    n = t.export(str(tmp / f"{ns.name}.json"))
    doc = json.load(open(tmp / f"{ns.name}.json", encoding="utf-8"))
    return [same, obs.current(), n, sorted(doc),
            _records(doc["traceEvents"]), _records(t.records())]


def s_attach(ns, mp, tmp):
    obs = ns.obs
    obs.configure(enabled=True)
    out = {}
    with obs.span("issuer") as sp:
        ctx = obs.current()

        def worker():
            with obs.attach(ctx):
                with obs.span("worker_side") as w:
                    out["trace"] = w.trace_id == sp.trace_id
                    out["parent"] = w.parent_id == sp.span_id

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    return out


def s_tracer_off(ns, mp, tmp):
    obs = ns.obs
    obs.reset()
    sp = obs.span("anything", key="x")
    with sp as s:
        s.event("nope")
    obs.event("also_nope")
    obs.record_span("still_nope", 0.0, 1.0)
    sup = ns.rt.DispatchSupervisor()
    val = sup.dispatch(lambda: 41, key="off.path")
    return [obs.recording(), sp is obs.NOOP_SPAN, val,
            len(obs.get_tracer())]


def s_ring(ns, mp, tmp):
    t = ns.obs.configure(enabled=True, ring_size=16)
    for i in range(50):
        ns.obs.event(f"e{i}")
    return [len(t), t.dropped, [r["name"] for r in t.records()],
            sorted(t.status())]


def s_stream(ns, mp, tmp):
    path = str(tmp / f"{ns.name}.jsonl")
    ns.obs.configure(enabled=True, stream=path)
    with ns.obs.span("streamed", tag="s"):
        pass
    ns.obs.event("inst")
    ns.obs.get_tracer().close()
    lines = [json.loads(x) for x in
             open(path, encoding="utf-8").read().splitlines()]
    return _records(lines)


def s_hist_quantiles(ns, mp, tmp):
    h = ns.obs.LatencyHistogram()
    for ms in range(1, 101):
        h.record(ms / 1e3)
    h.record(float("nan"))
    h.record(-1.0)
    h.record(float("inf"))
    e = ns.obs.LatencyHistogram()
    return [h.snapshot(), [h.quantile_ms(q) for q in (50, 90, 99)],
            e.quantile_ms(99), e.snapshot()]


def s_hist_set(ns, mp, tmp):
    hs = ns.obs.HistogramSet()
    hs.record(("device", "gls", "64"), "e2e", 0.004)
    hs.record(("device", "gls", "64"), "queue_wait", 0.001)
    hs.record(("host", "phase", "128"), "e2e", 0.020)
    return [len(hs), hs.snapshot()]


def s_hang_spans(ns, mp, tmp):
    mp.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "150")
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    t = ns.obs.configure(enabled=True)
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="obs.hang", kind="hang",
                                        seconds=1.0)])
    with plan.active():
        with ns.obs.span("caller.fit"):
            out = sup.dispatch(lambda: 1, key="obs.hang",
                               fallback=lambda: "host")
        out2 = sup.dispatch(lambda: 1, key="obs.hang",
                            fallback=lambda: "host2")
    return [out, out2, _records(t.records())]


def s_latency_snapshot(ns, mp, tmp):
    sup = ns.rt.DispatchSupervisor()
    sup.dispatch(lambda: time.sleep(0.002) or 7, key="obs.lat")
    sup.dispatch(lambda: 7, key="obs.lat")
    lat = sup.snapshot()["latency"]
    return [sorted(lat), lat["cpu/obs.lat"]["dispatch_wall"]["count"],
            sorted(lat["cpu/obs.lat"]["dispatch_wall"])]


def s_flight_breaker(ns, mp, tmp):
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    mp.setenv("PINT_TPU_DISPATCH_RETRIES", "0")
    fdir = tmp / f"flight-{ns.name}"
    ns.obs.configure(enabled=False, flight_dir=str(fdir))
    rec = ns.obs.recording()
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="obs.brk", kind="error")])
    with plan.active():
        out = sup.dispatch(lambda: 1, key="obs.brk",
                           fallback=lambda: "host")
    dumps = sorted(fdir.glob("flight-*.json"))
    doc = json.loads(dumps[0].read_text())
    st = ns.obs.status()
    return [rec, out, len(dumps), sorted(doc), doc["reason"],
            sorted(doc["extra"]), sorted(doc["extra"]["breaker"]),
            doc["extra"]["breaker"]["state"],
            sorted({e["name"] for e in doc["events"]}),
            sorted(doc["tracer"]), st["flight"]["dumps"],
            st["flight"]["last_reason"], sorted(st["flight"])]


def s_flight_rate(ns, mp, tmp):
    ns.obs.configure(enabled=True, flight_dir=str(tmp / ns.name))
    return [ns.obs.flight_dump("storm") is not None,
            ns.obs.flight_dump("storm") is None,
            ns.obs.flight_dump("other") is not None,
            ns.obs.get_flight().suppressed]


def s_env_knobs(ns, mp, tmp):
    cfg = ns.config
    out = [cfg.trace_enabled()]
    mp.setenv("PINT_TPU_TRACE", "on")
    out.append(cfg.trace_enabled())
    mp.setenv("PINT_TPU_TRACE_RING", "512")
    out.append(cfg.trace_ring_size())
    mp.setenv("PINT_TPU_TRACE_RING", "banana")
    out.append(cfg.trace_ring_size())
    mp.setenv("PINT_TPU_FLIGHT_DIR", "/tmp/f")
    out.append(cfg.flight_dir())
    return out


def s_rtt_override(ns, mp, tmp):
    cfg = ns.config
    out = [cfg.dispatch_rtt_override_ms()]
    mp.setenv("PINT_TPU_DISPATCH_RTT_MS", "42.5")
    out += [cfg.dispatch_rtt_override_ms(), cfg.dispatch_rtt_ms()]
    for bad in ("banana", "-5", "0", "nan", "inf"):
        mp.setenv("PINT_TPU_DISPATCH_RTT_MS", bad)
        out.append(cfg.dispatch_rtt_override_ms())
    mp.setenv("PINT_TPU_DISPATCH_RTT_MS", "not-a-number")
    out.append(ns.rt.DispatchSupervisor._peek_rtt_ms("cpu")
               == cfg.dispatch_rtt_ms())
    return out


def s_registry_types(ns, mp, tmp):
    reg = ns.om.get_registry()
    c = reg.counter("t_events_total", "help text")
    c.inc(pool="device")
    c.inc(2, pool="host")
    out = [c.value(pool="device"), c.value(pool="host"), c.total(),
           reg.counter("t_events_total") is c]
    with pytest.raises(TypeError):
        reg.gauge("t_events_total")
    g = reg.gauge("t_depth")
    g.set(7)
    g.set_max(3)
    out.append(g.value())
    g.set_max(11)
    out.append(g.value())
    h = reg.histogram("t_lat_seconds")
    h.observe(0.004, kind="gls")
    out.append(h.row(kind="gls").count)
    b = reg.counter("t_bumps_total").child(scope="s1")
    b.inc()
    b.inc(3)
    out.append(b.value())
    with pytest.raises(TypeError):
        b.set(0)
    return out + [_render(ns), reg.snapshot()]


def s_pull_gauge(ns, mp, tmp):
    g = ns.om.gauge("t_pull")
    state = {"v": 5.0}
    g.set_fn(lambda: state["v"], scope="e1")
    out = [g.series()]
    state["v"] = None
    out += [g.series(), "t_pull{" in ns.om.render()]
    state["v"] = 7.0
    return out + [g.series()]


def s_registry_reset(ns, mp, tmp):
    ns.om.counter("t_old_total").inc()
    old = ns.om.get_registry()
    ns.om.reset()
    return [ns.om.get_registry() is not old,
            ns.om.get_registry().value("t_old_total")]


def s_exposition(ns, mp, tmp):
    reg = ns.om.get_registry()
    reg.counter("rt_events_total", "ev").inc(5, pool="device", kind="gls")
    reg.gauge("rt_depth").set(3.5, scope="e1")
    h = reg.histogram("rt_lat_seconds")
    for ms in (0.5, 1.0, 3.0, 700.0):
        h.observe(ms / 1e3, kind="gls")
    reg.gauge("rt_big").set(1e16)
    reg.gauge("rt_flag").set(True)
    return reg.render()


def s_label_escaping(ns, mp, tmp):
    reg = ns.om.get_registry()
    reg.counter("esc_total").inc(key='we"ird\nname\\x')
    return reg.render()


def s_supervisor_parity(ns, mp, tmp):
    sup = ns.rt.DispatchSupervisor()
    for _ in range(3):
        sup.dispatch(lambda: 1, key="par.k")
    snap = sup.snapshot()
    reg = ns.om.get_registry()
    scope = sup.metrics.scope
    out = {name: reg.value(f"pint_tpu_dispatch_{name}_total",
                           scope=scope) == snap[name]
           for name in ("dispatches", "guarded", "retries", "timeouts",
                        "failovers", "breaker_rejections")}
    out["dispatches"] = snap["dispatches"]
    out["compile_wall"] = reg.value("pint_tpu_compile_wall_seconds",
                                    scope=scope, key="par.k") > 0.0
    row = reg.get("pint_tpu_dispatch_wall_seconds").row(
        scope=scope, pool="cpu", key="par.k", metric="dispatch_wall")
    out["rows"] = row.count == \
        snap["latency"]["cpu/par.k"]["dispatch_wall"]["count"] == 3
    # the supervisor's metric names, but the port's device_lost counter
    # and the reference's perf plane (not ported)
    out["names"] = sorted(
        n for n in {ln.split()[2] for ln in reg.render().splitlines()
                    if ln.startswith("# TYPE")}
        if n != "pint_tpu_dispatch_device_lost_total"
        and not n.startswith("pint_tpu_perf_"))
    return out


def s_metrics_server(ns, mp, tmp):
    ns.om.counter("srv_events_total").inc(7)
    srv = ns.om.MetricsServer(port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read().decode())
            ctype = r.headers.get("Content-Type")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.close()
    return ["srv_events_total 7" in text.splitlines(), h["ok"],
            h["breakers"], ctype]


SHARED = {
    # tests/test_obs.py
    "test_span_nesting_context_and_export": s_span_nesting,
    "test_attach_propagates_context_across_threads": s_attach,
    "test_tracer_off_hot_path_emits_zero_records": s_tracer_off,
    "test_ring_bounds_and_drop_accounting": s_ring,
    "test_jsonl_stream_mode": s_stream,
    "test_histogram_quantiles_against_known_samples": s_hist_quantiles,
    "test_histogram_set_keys_and_snapshot": s_hist_set,
    "test_hang_failover_spans_in_causal_order": s_hang_spans,
    "test_supervisor_latency_histograms_in_snapshot": s_latency_snapshot,
    "test_flight_recorder_dumps_on_breaker_open_plan": s_flight_breaker,
    "test_flight_dump_rate_limited_per_reason": s_flight_rate,
    "test_obs_env_knobs": s_env_knobs,
    "test_dispatch_rtt_override_validated": s_rtt_override,
    # tests/test_metrics.py
    "test_registry_types_and_labels": s_registry_types,
    "test_pull_gauge_stops_exporting_when_producer_dies": s_pull_gauge,
    "test_registry_reset_isolation": s_registry_reset,
    "test_exposition_parses_and_round_trips": s_exposition,
    "test_label_escaping": s_label_escaping,
    "test_supervisor_registry_snapshot_parity": s_supervisor_parity,
    "test_metrics_server_scrape_and_healthz": s_metrics_server,
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


def test_render_text_identical_for_one_op_sequence():
    """One sequence of counter, gauge and histogram operations (labels,
    watermarks, bound children, log buckets) renders the same text in
    both packages, byte for byte."""
    texts = []
    for which in ("ref", "port"):
        ns = _ns(which)
        _reset(ns)
        om = ns.om
        c = om.counter("seq_total", "a counter")
        c.inc(3, pool="device", kind="gls")
        c.child(scope="x").inc(2.5)
        g = om.gauge("seq_gauge", "a gauge")
        g.set(-1.25, scope="x")
        g.set_max(4, scope="y")
        g.set_max(2, scope="y")
        h = om.histogram("seq_seconds", "a histogram")
        for s in (1e-7, 3e-6, 0.25, 2.0, 1e6, 0.0):
            h.observe(s, kind="k", metric="m")
        texts.append(om.render())
        _reset(ns)
    assert texts[0] == texts[1]


def test_sample_device_memory_never_initializes_cuda():
    from pint_tpu_torch.obs import metrics as om

    assert om.sample_device_memory() is None
    assert not torch.cuda.is_initialized()


def test_flight_dump_coerces_bad_extras(tmp_path):
    from pint_tpu_torch import obs

    obs.configure(enabled=True, flight_dir=str(tmp_path))
    path = obs.flight_dump("odd", arr=np.arange(3), obj=object(),
                           nested={"t": (1, np.float64(2.0))})
    doc = json.loads(open(path, encoding="utf-8").read())
    assert sorted(doc["extra"]) == ["arr", "nested", "obj"]
    assert doc["reason"] == "odd" and doc["pid"] > 0
