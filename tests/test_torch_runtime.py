"""The port's runtime layer (pint_tpu_torch.runtime and the locks) on the
CPU, held to the reference pint_tpu.runtime.

``test_shared_semantics`` has one case for each test of
tests/test_runtime_faults.py and tests/test_locks.py whose behaviour both
packages share (the serve, fleet, chaos and health cases belong to
layers the port does not have yet). Each case runs one scenario through
both packages — the same dispatches, fault plans, breakers and locks —
and holds the port's outcome (values, raised types, counters, breaker
states, lock graphs) equal to the reference's. Where the reference takes
an accelerator backend from a patched ``jax.default_backend`` ("tpu"),
the port dispatches to ``device="cuda:0"``: the breaker key, the guard
rule and the deadline floor follow the device, and nothing here touches
a card (a deadline override or a cached RTT keeps the deadline logic
from measuring one).

The rest are the port's own: the LOST state a sticky CUDA error latches,
the sticky and OOM classification, the CUDA deadline floor, the async
drain, drift inside and outside its window, grad mode in the worker and
the ``shadow=`` refused for failover results and pinned calls. Deadlines are 150-500 ms and hangs at most 3 s.
"""

import threading
import time
import types

import pytest
import torch

from pint_tpu_torch import config as pconfig
from pint_tpu_torch import obs as pobs
from pint_tpu_torch.obs import metrics as pom
from pint_tpu_torch.runtime import (
    CLOSED,
    LOST,
    OPEN,
    DeviceLost,
    DispatchSupervisor,
    DispatchTimeout,
    Fault,
    FaultPlan,
    breaker_for,
    locks as plocks,
    reset_runtime,
)
from pint_tpu_torch.runtime import supervisor as psup


def _ns(which):
    if which == "ref":
        import pint_tpu.config as cfg
        import pint_tpu.runtime as rt
        from pint_tpu import obs
        from pint_tpu.obs import metrics as om
        from pint_tpu.runtime import locks
        from pint_tpu.runtime import supervisor as sup
    else:
        cfg, obs, om, locks, sup = pconfig, pobs, pom, plocks, psup
        import pint_tpu_torch.runtime as rt
    return types.SimpleNamespace(name=which, rt=rt, config=cfg, obs=obs,
                                 om=om, locks=locks, sup=sup)


def _reset(ns):
    ns.rt.reset_runtime()
    ns.obs.reset()
    ns.config._RTT_MS.clear()


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("PINT_TPU_LOCK_TRACE", raising=False)
    monkeypatch.delenv("PINT_TPU_DISPATCH_RTT_MS", raising=False)
    for which in ("ref", "port"):
        _reset(_ns(which))
    yield
    for which in ("ref", "port"):
        _reset(_ns(which))


class _Accel:
    """The accelerator of a scenario: the reference's patched "tpu"
    backend, or the port's "cuda:0" device."""

    def __init__(self, ns, monkeypatch):
        self.ns = ns
        if ns.name == "ref":
            import jax

            monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
            self.backend, self.kw = "tpu", {}
        else:
            self.backend, self.kw = "cuda:0", {"device": "cuda:0"}

    def breaker(self):
        return self.ns.rt.breaker_for(self.backend)


# ------------------------------------------------------------ scenarios
# each takes (ns, monkeypatch) and returns the outcome both packages
# must share


def s_timeout_without_fallback(ns, mp):
    mp.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "150")
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="solo", kind="hang",
                                        seconds=3.0)])
    t0 = time.monotonic()
    with plan.active():
        with pytest.raises(ns.rt.DispatchTimeout):
            sup.dispatch(lambda: 1, key="solo")
    return {"bounded": time.monotonic() - t0 < 1.5,
            "timeouts": sup.metrics.timeouts,
            "abandoned": sup.metrics.abandoned_workers,
            "applied": plan.applied}


def s_transient_retry(ns, mp):
    mp.setenv("PINT_TPU_DISPATCH_BACKOFF_MS", "1")
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="rt", kind="error",
                                        count=2)])
    with plan.active():
        out = sup.dispatch(lambda: 7, key="rt")
    return {"out": out, "transient": sup.metrics.transient_errors,
            "retries": sup.metrics.retries,
            "state": ns.rt.breaker_for("cpu").state}


def s_fatal_reraises(ns, mp):
    sup = ns.rt.DispatchSupervisor()

    def boom():
        raise TypeError("bad operand")

    with pytest.raises(TypeError):
        sup.dispatch(boom, key="fatal", fallback=lambda: "host")
    return {"failovers": sup.metrics.failovers,
            "retries": sup.metrics.retries,
            "state": ns.rt.breaker_for("cpu").state}


def s_breaker_trip_recover(ns, mp):
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "3")
    mp.setenv("PINT_TPU_BREAKER_COOLDOWN_S", "0.05")
    mp.setenv("PINT_TPU_DISPATCH_RETRIES", "0")
    sup = ns.rt.DispatchSupervisor()
    calls = []

    def device():
        calls.append(1)
        return 42

    out = {}
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="brk", kind="error")],
                           probe_ok=False)
    with plan.active():
        out["first"] = [sup.dispatch(device, key="brk",
                                     fallback=lambda: "host")
                        for _ in range(3)]
        br = ns.rt.breaker_for("cpu")
        out["tripped"] = (br.state, br.trips)
        n = len(calls)
        out["short"] = sup.dispatch(device, key="brk",
                                    fallback=lambda: "host")
        out["untouched"] = len(calls) == n
        time.sleep(0.07)
        out["still_dead"] = (sup.dispatch(device, key="brk",
                                          fallback=lambda: "host"),
                             br.state)
        plan.clear()
        plan.probe_ok = True
        time.sleep(br.cooldown_s + 0.02)
        out["recovered"] = (sup.dispatch(device, key="brk",
                                         fallback=lambda: "host"),
                            br.state)
    out["recoveries"] = sup.metrics.breaker_recoveries
    out["rejections"] = sup.metrics.breaker_rejections >= 1
    return out


def s_half_open_reopens(ns, mp):
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    mp.setenv("PINT_TPU_BREAKER_COOLDOWN_S", "0.03")
    mp.setenv("PINT_TPU_DISPATCH_RETRIES", "0")
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="ho", kind="error")],
                           probe_ok=True)
    with plan.active():
        with pytest.raises(Exception):
            sup.dispatch(lambda: 1, key="ho")
        br = ns.rt.breaker_for("cpu")
        first = br.state
        time.sleep(0.05)
        with pytest.raises(Exception):
            sup.dispatch(lambda: 1, key="ho")
    return {"first": first, "state": br.state, "trips": br.trips}


def s_fatal_half_open(ns, mp):
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    mp.setenv("PINT_TPU_BREAKER_COOLDOWN_S", "0.03")
    mp.setenv("PINT_TPU_DISPATCH_RETRIES", "0")
    sup = ns.rt.DispatchSupervisor()
    plan = ns.rt.FaultPlan([ns.rt.Fault(match="fho", kind="error",
                                        count=1)], probe_ok=True)
    out = {}
    with plan.active():
        with pytest.raises(Exception):
            sup.dispatch(lambda: 1, key="fho")
        br = ns.rt.breaker_for("cpu")
        out["tripped"] = br.state
        time.sleep(0.05)

        def bug():
            raise TypeError("caller bug during the trial")

        with pytest.raises(TypeError):
            sup.dispatch(bug, key="fho")
        out["aborted"] = br.state
        time.sleep(0.05)
        out["value"] = sup.dispatch(lambda: 9, key="fho")
        out["closed"] = br.state
    return out


def s_async_fatal(ns, mp):
    sup = ns.rt.DispatchSupervisor()

    def boom():
        raise TypeError("bad operand")

    fut = sup.dispatch_async(boom, key="afatal", fallback=lambda: "host")
    with pytest.raises(TypeError):
        fut.result()
    return {"failovers": sup.metrics.failovers,
            "state": ns.rt.breaker_for("cpu").state}


def s_no_drift_pipelined(ns, mp):
    acc = _Accel(ns, mp)
    sup = ns.rt.DispatchSupervisor()
    sup._seen.add("pk")
    ns.config._RTT_MS[acc.backend] = 8.0
    sup._note_wall("pk", 1, 0.2, acc.backend, depth=2)
    first = sup.metrics.rtt_remeasures
    sup._note_wall("pk", 1, 0.2, acc.backend, depth=1)
    return {"pipelined": first, "unoverlapped": sup.metrics.rtt_remeasures}


def s_no_drift_inside_window(ns, mp):
    # a wall at the prediction (the reference's version pads a real
    # dispatch by 8 ms; the verdict is fed directly here, so scheduler
    # noise cannot move it out of the window)
    acc = _Accel(ns, mp)
    sup = ns.rt.DispatchSupervisor()
    ns.config._RTT_MS[acc.backend] = 8.0
    sup._note_wall("ok", 1, 0.008, acc.backend)
    sup._note_wall("ok", 1, 0.012, acc.backend)
    return {"remeasures": sup.metrics.rtt_remeasures}


def s_no_drift_chained(ns, mp):
    acc = _Accel(ns, mp)
    sup = ns.rt.DispatchSupervisor()
    ns.config._RTT_MS[acc.backend] = 40.0
    sup._note_wall("chain", 16, 0.06, acc.backend)
    return {"remeasures": sup.metrics.rtt_remeasures}


def s_transient_narrow(ns, mp):
    f = ns.sup._is_transient
    return [f(ConnectionResetError("peer reset")), f(BrokenPipeError("p")),
            f(TimeoutError("socket timed out")),
            f(FileNotFoundError("missing.clk")), f(PermissionError("d")),
            f(ValueError("bad shape")),
            f(ns.rt.TransientFault("x")), f(ns.rt.FatalFault("y"))]


def s_pinned_bypass(ns, mp):
    acc = _Accel(ns, mp)
    sup = ns.rt.DispatchSupervisor()
    br = acc.breaker()
    for _ in range(br.threshold):
        br.on_result(False)
    opened = br.state
    val = sup.dispatch(lambda: 5, key="pin", pinned=True, **acc.kw)
    return {"opened": opened, "value": val, "state": br.state,
            "rejections": sup.metrics.breaker_rejections}


def s_env_knobs(ns, mp):
    cfg = ns.config
    out = []
    mp.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "1234")
    out.append(cfg.dispatch_deadline_ms())
    mp.delenv("PINT_TPU_DISPATCH_DEADLINE_MS")
    out.append(cfg.dispatch_deadline_ms())
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "5")
    out.append(cfg.breaker_threshold())
    mp.setenv("PINT_TPU_BREAKER_THRESHOLD", "banana")
    out.append(cfg.breaker_threshold())
    for name, val in (("PINT_TPU_DISPATCH_RETRIES", "-3"),
                      ("PINT_TPU_DISPATCH_BACKOFF_MS", "7.5"),
                      ("PINT_TPU_DISPATCH_COMPILE_ALLOWANCE_MS", "x"),
                      ("PINT_TPU_BREAKER_COOLDOWN_S", "-1"),
                      ("PINT_TPU_BREAKER_PROBE_TIMEOUT_S", "0.2"),
                      ("PINT_TPU_TRACE_RING", "12"),
                      ("PINT_TPU_DISPATCH_RTT_MS", "-4")):
        mp.setenv(name, val)
    out += [cfg.dispatch_retries(), cfg.dispatch_backoff_ms(),
            cfg.dispatch_compile_allowance_ms(), cfg.breaker_cooldown_s(),
            cfg.breaker_probe_timeout_s(), cfg.trace_ring_size(),
            cfg.dispatch_rtt_override_ms()]
    mp.setenv("PINT_TPU_LOCK_TRACE", "maybe")
    out.append(cfg.lock_trace_enabled())
    out.append(cfg.lock_trace_enabled(True))
    mp.setenv("PINT_TPU_FLIGHT_DIR", "/x")
    mp.setenv("PINT_TPU_TRACE", "on")
    out += [cfg.flight_dir(), cfg.trace_enabled(), cfg.trace_stream_path()]
    return out


# -- test_locks.py's


def s_locks_disarmed(ns, mp):
    lk_mod = ns.locks
    lk_mod.configure(enabled=False)
    lk = lk_mod.make_lock("t.bare")
    rk = lk_mod.make_rlock("t.bare_r")
    cv = lk_mod.make_condition(rk)
    with cv:
        cv.notify_all()
    with lk:
        pass
    return [type(lk) is type(threading.Lock()),
            type(rk) is type(threading.RLock()),
            isinstance(cv, threading.Condition),
            lk_mod.status()["edges"], lk_mod.held_locks()]


def s_locks_env_default(ns, mp):
    return [type(ns.locks.make_lock("t.env")) is type(threading.Lock()),
            ns.locks.status()["armed"]]


def s_locks_paint(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    a, b = L.make_lock("t.A"), L.make_lock("t.B")
    out = [isinstance(a, L.TracedLock)]
    with a:
        out.append(L.held_locks())
        with b:
            out.append(L.held_locks())
    out += [L.held_locks(), L.lock_graph_edges(), L.status(),
            "pint_tpu_lock_hold_seconds" in ns.om.get_registry().render()]
    return out


def s_locks_reentrant(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    r = L.make_rlock("t.R")
    out = []
    with r:
        with r:
            out.append(L.held_locks())
        out.append(L.held_locks())
    return out + [L.held_locks(), L.lock_graph_edges()]


def s_locks_siblings(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    a1, a2 = L.make_lock("t.same"), L.make_lock("t.same")
    with a1:
        with a2:
            pass
    return [L.lock_graph_edges(), L.status()["cycles_fired"]]


def s_locks_condition(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    cv = L.make_condition(L.make_rlock("t.cv"))
    state = {"woke": False, "held": None}

    def waiter():
        with cv:
            cv.wait(timeout=5)
            state["woke"] = True
            state["held"] = L.held_locks()

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    for _ in range(500):
        with cv:
            cv.notify_all()
        th.join(timeout=0.01)
        if not th.is_alive():
            break
    th.join(timeout=5)
    return [th.is_alive(), state["woke"], state["held"], L.held_locks()]


def s_locks_inversion(ns, mp, tmp_path):
    d = tmp_path / ns.name
    ns.obs.configure(enabled=True, flight_dir=str(d))
    L = ns.locks
    L.configure(enabled=True)
    a, b = L.make_lock("t.A"), L.make_lock("t.B")
    with a:
        with b:
            pass
    for _ in range(3):
        with b:
            with a:
                pass
    return [L.status()["cycles_fired"],
            int(ns.om.get_registry().total(
                "pint_tpu_lock_incidents_total")),
            len(list(d.glob("flight-*lockorder*.json")))]


def s_locks_reset(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    a, b = L.make_lock("t.A"), L.make_lock("t.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    out = [L.status()["cycles_fired"]]
    ns.obs.reset()
    out.append(L.status())
    L.configure(enabled=True)
    with b:
        with a:
            pass
    with a:
        with b:
            pass
    return out + [L.status()["cycles_fired"]]


def s_locks_dispatch_clear(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    eng = L.make_rlock("t.engine", engine=True)
    leaf = L.make_lock("t.leaf")
    out = [L.check_dispatch_clear("t")]
    with leaf:
        out.append(L.check_dispatch_clear("t"))
    with eng:
        out += [L.check_dispatch_clear("t"), L.check_dispatch_clear("t")]
    out += [L.status()["held_fired"],
            int(ns.om.get_registry().total(
                "pint_tpu_lock_incidents_total")),
            L.check_dispatch_clear("t")]
    return out


def s_locks_contention(ns, mp):
    L = ns.locks
    L.configure(enabled=True)
    lk = L.make_lock("t.cont")
    lk.acquire()
    state = {}

    def contender():
        with lk:
            state["got"] = True

    th = threading.Thread(target=contender, daemon=True)
    th.start()
    th.join(timeout=0.05)
    lk.release()
    th.join(timeout=5)
    return [state.get("got"),
            "pint_tpu_lock_wait_seconds" in ns.om.get_registry().render()]


SHARED = {
    # tests/test_runtime_faults.py
    "test_timeout_without_fallback_raises_bounded": s_timeout_without_fallback,
    "test_transient_errors_retry_then_succeed": s_transient_retry,
    "test_fatal_errors_reraise_untouched": s_fatal_reraises,
    "test_breaker_trips_short_circuits_and_recovers": s_breaker_trip_recover,
    "test_half_open_trial_failure_reopens": s_half_open_reopens,
    "test_fatal_during_half_open_does_not_strand_breaker": s_fatal_half_open,
    "test_async_fatal_error_propagates_through_future": s_async_fatal,
    "test_no_drift_verdict_inside_window": s_no_drift_inside_window,
    "test_no_drift_for_healthy_chained_dispatch": s_no_drift_chained,
    "test_no_drift_verdict_for_pipelined_dispatches": s_no_drift_pipelined,
    "test_transient_classification_is_narrow": s_transient_narrow,
    "test_pinned_dispatches_bypass_the_breaker": s_pinned_bypass,
    "test_runtime_env_knobs_parse": s_env_knobs,
    # tests/test_locks.py
    "test_disarmed_factories_return_bare_stdlib_primitives": s_locks_disarmed,
    "test_env_default_is_disarmed": s_locks_env_default,
    "test_armed_lock_paints_acquisition_order": s_locks_paint,
    "test_reentrant_rlock_is_one_held_entry_no_self_edge": s_locks_reentrant,
    "test_sibling_instances_of_one_name_share_a_node": s_locks_siblings,
    "test_condition_protocol_over_traced_rlock": s_locks_condition,
    "test_inversion_fires_exactly_one_incident_per_episode":
        s_locks_inversion,
    "test_obs_reset_drops_graph_latches_and_rearms": s_locks_reset,
    "test_check_dispatch_clear_fires_once_per_lock_name":
        s_locks_dispatch_clear,
    "test_contention_wait_rides_the_registry_histogram": s_locks_contention,
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_semantics(case, monkeypatch, tmp_path):
    """One scenario through the reference and through the port: the same
    outcome."""
    scenario = SHARED[case]
    got = {}
    for which in ("ref", "port"):
        ns = _ns(which)
        with monkeypatch.context() as mp:
            _reset(ns)
            args = (ns, mp, tmp_path) if "tmp_path" in \
                scenario.__code__.co_varnames[:3] else (ns, mp)
            got[which] = scenario(*args)
            _reset(ns)
    assert got["port"] == got["ref"]


# ------------------------------------------------------ the port's own


def test_breaker_state_machine():
    """CLOSED -> OPEN at the threshold, rejects through the cooldown, a
    failed probe re-arms with a doubled cooldown, a good probe gives one
    HALF_OPEN trial whose success closes it; LOST rejects forever, never
    probes (even with cooldown 0), ignores results, and only reset
    clears it."""
    from pint_tpu_torch.runtime import HALF_OPEN, CircuitBreaker

    probes = []

    def probe():
        probes.append(1)
        return len(probes) > 1

    br = CircuitBreaker("cuda:0", threshold=2, cooldown_s=0.02, probe=probe)
    br.on_result(False)
    assert br.state == CLOSED and br.allow() == "proceed"
    br.on_result(False)
    assert br.state == OPEN and br.trips == 1 and br.allow() == "reject"
    time.sleep(0.03)
    assert br.allow() == "reject" and br.cooldown_s == pytest.approx(0.04)
    time.sleep(0.05)
    assert br.allow() == "probe" and br.state == HALF_OPEN
    assert br.allow() == "reject"          # one trial at a time
    br.on_result(True)
    assert br.state == CLOSED and br.cooldown_s == pytest.approx(0.02)

    lost = CircuitBreaker("cuda:0", threshold=3, cooldown_s=0.0,
                          probe=lambda: probes.append(2) or True)
    lost.latch()
    n = len(probes)
    assert lost.state == LOST and lost.is_open and lost.is_lost
    assert lost.trips == 1
    for _ in range(3):
        assert lost.allow() == "reject"
    lost.on_result(True)
    assert lost.state == LOST and len(probes) == n
    assert lost.snapshot()["state"] == "lost"
    lost.reset()
    assert lost.state == CLOSED


class AcceleratorError(RuntimeError):
    """Stands in for torch.AcceleratorError (a RuntimeError subclass of
    that name)."""


@pytest.mark.parametrize("exc,sticky,transient", [
    (AcceleratorError("CUDA error: an illegal memory access was "
                      "encountered"), True, False),
    (RuntimeError("CUDA error: device-side assert triggered\nCUDA kernel "
                  "errors might be asynchronously reported"), True, False),
    (RuntimeError("CUDA error: unspecified launch failure"), True, False),
    (AcceleratorError("CUDA error: an illegal instruction was "
                      "encountered"), True, False),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     True, False),
    # caller bugs: a card without an image, a failed build, a shape bug
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), False, False),
    (RuntimeError("nvcc failed: exit status 1"), False, False),
    (RuntimeError("illegal memory access in my own message"), False, False),
    (ValueError("device-side assert"), False, False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), False, True),
])
def test_sticky_and_transient_classification(exc, sticky, transient):
    assert psup._is_sticky(exc) is sticky
    assert psup._is_transient(exc) is transient


def test_sticky_error_latches_and_fails_over(monkeypatch):
    """A sticky error on a CUDA dispatch: no retry, the cuda:0 breaker
    latched LOST, the dispatch answered by its fallback (labelled
    DeviceLost); without a fallback the DeviceLost raises with the
    device's error as its cause; a later dispatch short-circuits without
    calling fn, even with cooldown 0; the CPU breaker is untouched."""
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "500")
    monkeypatch.setenv("PINT_TPU_BREAKER_COOLDOWN_S", "0")
    sup = DispatchSupervisor()
    calls = []

    def dead():
        calls.append(1)
        raise AcceleratorError("CUDA error: device-side assert triggered")

    assert sup.dispatch(dead, key="k", device="cuda:0",
                        fallback=lambda: "host") == "host"
    assert len(calls) == 1
    snap = sup.snapshot()
    assert snap["device_lost"] == 1 and snap["failovers"] == 1
    assert snap["retries"] == 0 and snap["transient_errors"] == 0
    assert snap["breakers"]["cuda:0"]["state"] == LOST
    with pytest.raises(Exception) as ei:
        sup.dispatch(lambda: 1, key="k2", device="cuda:0")
    assert type(ei.value).__name__ == "BackendUnavailable"
    assert sup.dispatch(dead, key="k", device="cuda:0",
                        fallback=lambda: "host") == "host"
    assert len(calls) == 1                  # never touched again
    assert sup.metrics.breaker_rejections == 2
    assert breaker_for("cpu").state == CLOSED

    reset_runtime()
    with pytest.raises(DeviceLost) as ei:
        sup.dispatch(dead, key="k", device="cuda:0")
    assert isinstance(ei.value.__cause__, AcceleratorError)
    # a caller bug on the card re-raises untouched and latches nothing
    reset_runtime()

    def no_image():
        raise RuntimeError("CUDA error: no kernel image is available")

    with pytest.raises(RuntimeError, match="no kernel image"):
        sup.dispatch(no_image, key="k", device="cuda:0",
                     fallback=lambda: "host")
    assert breaker_for("cuda:0").state == CLOSED


def test_oom_retries_then_recovers(monkeypatch):
    monkeypatch.setenv("PINT_TPU_DISPATCH_BACKOFF_MS", "1")
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "500")
    sup = DispatchSupervisor()
    n = []

    def flaky():
        n.append(1)
        if len(n) < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    assert sup.dispatch(flaky, key="oom", device="cuda:0") == "ok"
    assert sup.metrics.retries == 2 and sup.metrics.transient_errors == 2
    assert breaker_for("cuda:0").state == CLOSED


def test_backoff_is_jittered_exponential(monkeypatch):
    monkeypatch.setenv("PINT_TPU_DISPATCH_BACKOFF_MS", "10")
    for attempt in range(4):
        for _ in range(20):
            b = psup._backoff_s(attempt)
            assert 0.01 * 2 ** attempt <= b <= 0.015 * 2 ** attempt


def test_deadline_floors_and_override(monkeypatch):
    """The CPU keeps the reference's 1 s floor; CUDA's floor is 300 s;
    the first call per key adds the compile allowance; the override is
    per dispatch and scales with the pipeline depth."""
    sup = DispatchSupervisor()
    pconfig._RTT_MS["cpu"] = 0.01
    pconfig._RTT_MS["cuda:0"] = 0.05
    allow = pconfig.dispatch_compile_allowance_ms() / 1e3
    assert sup._deadline_s("a", 1, "cpu") == pytest.approx(1.0 + allow)
    assert sup._deadline_s("a", 1, "cuda:0") == pytest.approx(300 + allow)
    sup._seen.add("a")
    assert sup._deadline_s("a", 1, "cpu") == pytest.approx(1.0)
    assert sup._deadline_s("a", 256, "cuda:0", depth=2) == \
        pytest.approx(300.0)
    pconfig._RTT_MS["cuda:0"] = 250.0     # a slow round trip still scales
    assert sup._deadline_s("a", 256, "cuda:0") == \
        pytest.approx(8 * 250 * 256 / 1e3)
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "400")
    assert sup._deadline_s("b", 1, "cuda:0") == pytest.approx(0.4)
    assert sup._deadline_s("b", 1, "cuda:0", depth=3) == pytest.approx(1.2)


def test_guard_rule_follows_the_device(monkeypatch):
    """Inline on the CPU without a plan; guarded on CUDA and under any
    plan; pinned stays inline."""
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "500")
    sup = DispatchSupervisor()
    me = threading.get_ident()

    def where():
        return threading.get_ident() == me

    assert sup.dispatch(where, key="g") is True
    assert sup.dispatch(where, key="g", device="cuda:0") is False
    assert sup.dispatch(where, key="g", device="cuda:0",
                        pinned=True) is True
    with FaultPlan([]).active():
        assert sup.dispatch(where, key="g") is False
    assert sup.metrics.guarded == 2


def test_worker_keeps_grad_and_inference_mode(monkeypatch):
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "500")
    sup = DispatchSupervisor()

    def modes():
        return torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    with torch.no_grad():
        assert sup.dispatch(modes, key="m", device="cuda:0") == \
            (False, False)
    with torch.inference_mode():
        assert sup.dispatch(modes, key="m", device="cuda:0") == \
            (False, True)
    assert sup.dispatch(modes, key="m", device="cuda:0") == (True, False)


def test_host_read_and_nan_like():
    out = psup._host_read((torch.ones(2), [1, "x"], {"a": 2.0}))
    assert torch.equal(out[0], torch.ones(2)) and out[1] == [1, "x"]
    bad = psup._nan_like((torch.ones(2), torch.ones(2, dtype=torch.long),
                          3, True, 2.5, ["n"], None))
    assert torch.isnan(bad[0]).all()
    assert torch.equal(bad[1], torch.ones(2, dtype=torch.long))
    assert bad[2:4] == (3, True) and float(bad[4]) != float(bad[4])
    assert bad[5] == ["n"] and bad[6] is None


def test_async_drain_under_a_wedge(monkeypatch):
    """Every future of a pipeline whose later dispatches hang completes
    through its fallback: zero hung futures, depth-scaled deadlines."""
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "200")
    sup = DispatchSupervisor()
    plan = FaultPlan([Fault(match="pipe", kind="hang", seconds=2.0,
                            after=1)])
    t0 = time.monotonic()
    with plan.active():
        futs = [sup.dispatch_async(lambda i=i: i, key="pipe",
                                   fallback=lambda i=i: -i)
                for i in range(4)]
        got = [f.result(timeout=5) for f in futs]
    assert time.monotonic() - t0 < 1.9
    assert got[0] == 0 and got[1:] == [-1, -2, -3]
    assert sup.metrics.max_inflight >= 2
    assert sup.metrics.timeouts == 3 and sup.metrics.failovers == 3
    assert sup.inflight == 0


def test_drift_verdicts_on_cpu():
    """Outside the window a verdict re-measures the CPU round trip and
    re-picks K (1 on the CPU); inside it, and below the 5 ms floor,
    nothing fires."""
    sup = DispatchSupervisor()
    pconfig._RTT_MS["cpu"] = 8.0
    sup._note_wall("d", 1, 0.009, "cpu")
    sup._note_wall("d", 4, 0.060, "cpu")
    assert sup.metrics.rtt_remeasures == 0
    sup._note_wall("d", 1, 0.030, "cpu")             # > 2 x 8 ms
    assert sup.metrics.rtt_remeasures == 1
    assert sup.metrics.last_k == 1
    assert pconfig._RTT_MS["cpu"] < 8.0              # measured again
    sup._note_wall("d", 1, 10.0, "cpu")              # below the floor now
    assert sup.metrics.rtt_remeasures == 1


def test_injected_drift_fires_through_a_dispatch(monkeypatch):
    sup = DispatchSupervisor()
    pconfig._RTT_MS["cpu"] = 8.0
    sup.dispatch(lambda: 1, key="dr")                # warms the key
    with FaultPlan([Fault(match="dr", kind="rtt_drift",
                          factor=1e6)]).active():
        sup.dispatch(lambda: 1, key="dr")
    assert sup.metrics.rtt_remeasures == 1


def test_rtt_is_measured_per_device(monkeypatch):
    rtt = pconfig.dispatch_rtt_ms("cpu")
    assert 0.0 < rtt < 50.0 and pconfig._RTT_MS["cpu"] == rtt
    assert pconfig.auto_steps_per_dispatch("cpu") == 1
    pconfig._RTT_MS["cuda:0"] = 0.03
    assert pconfig.auto_steps_per_dispatch("cuda:0") == 4
    pconfig._RTT_MS["cuda:0"] = 200.0
    assert pconfig.auto_steps_per_dispatch("cuda:0") == 32
    monkeypatch.setenv("PINT_TPU_DISPATCH_RTT_MS", "12.5")
    assert pconfig.dispatch_rtt_ms("cuda:0") == 12.5


def test_solve_pinning_is_opt_in(monkeypatch):
    assert pconfig.solve_device(62, "cuda") is None
    assert pconfig.solve_device(62, "cpu") is None
    monkeypatch.setenv("PINT_TPU_HOST_SOLVE_MAX_TOA", "1024")
    assert pconfig.solve_device(62, "cuda") == torch.device("cpu")
    assert pconfig.solve_device(2048, "cuda") is None
    assert pconfig.solve_device(62, "cpu") is None
    with pconfig.solve_scope(62, "cuda"):
        assert torch.empty(1).device.type == "cpu"


def test_backend_of():
    assert psup.backend_of(None) == "cpu"
    assert psup.backend_of("cpu") == "cpu"
    assert psup.backend_of(torch.device("cpu")) == "cpu"
    assert psup.backend_of("cuda:1") == "cuda:1"
    assert psup.backend_of(torch.device("cuda", 0)) == "cuda:0"
    assert psup.backend_of("cuda") == "cuda:0"   # CUDA not initialized


def test_probe_subprocess_is_bounded(monkeypatch):
    """The half-open probe touches the card in a child process: here,
    without a GPU, it answers False, within its timeout."""
    t0 = time.monotonic()
    assert psup.bounded_backend_probe(timeout_s=60.0) is False
    assert time.monotonic() - t0 < 60.0
    with FaultPlan([], probe_ok=True).active():
        assert psup._probe_for("cuda:0")() is True
    assert psup._probe_for("cpu")() is True


def test_shadow_is_refused(monkeypatch):
    """The shadow runs on a successful device dispatch and is refused for
    a failover result and for a pinned (host) call: both ran on the
    host, so a mirror replay of them would read as zero drift."""
    from pint_tpu_torch.obs import health as phealth

    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "150")
    mon = phealth.configure(enabled=True, shadow_rate=1)
    seen = []

    def shadow(out):
        seen.append(out)
        return 0.0

    sup = DispatchSupervisor()
    assert sup.dispatch(lambda: 1, key="s", shadow=shadow) == 1
    with FaultPlan([Fault(match="s.fail", kind="hang", seconds=1.0)]).active():
        assert sup.dispatch(lambda: 1, key="s.fail", fallback=lambda: 2,
                            shadow=shadow) == 2
    assert sup.dispatch(lambda: 3, key="s.pin", pinned=True,
                        shadow=shadow) == 3
    t0 = time.monotonic()
    while mon._c_shadow.total() < 1 and time.monotonic() - t0 < 30.0:
        time.sleep(0.02)
    time.sleep(0.1)
    assert seen == [1]
    assert mon.status()["shadow_replays"] == 1


def test_metrics_are_registry_backed_and_spans_label_the_episode(
        monkeypatch, tmp_path):
    """The counters are the registry's (render() and snapshot() agree),
    and a traced failover leaves its dispatch span, its timeout and
    failover events and a flight dump of the breaker opening."""
    monkeypatch.setenv("PINT_TPU_DISPATCH_DEADLINE_MS", "150")
    monkeypatch.setenv("PINT_TPU_BREAKER_THRESHOLD", "1")
    tracer = pobs.configure(enabled=True, flight_dir=str(tmp_path))
    sup = DispatchSupervisor()
    with FaultPlan([Fault(match="ep", kind="hang", seconds=1.0)]).active():
        assert sup.dispatch(lambda: 1, key="ep",
                            fallback=lambda: "host") == "host"
    text = pom.render()
    line = [ln for ln in text.splitlines()
            if ln.startswith("pint_tpu_dispatch_failovers_total{")
            and sup.metrics.scope in ln]
    assert line and line[0].endswith(" 1")
    names = [r["name"] for r in tracer.records()]
    for n in ("dispatch.timeout", "breaker.open", "dispatch.failover",
              "dispatch/ep"):
        assert n in names
    assert list(tmp_path.glob("flight-*breaker_open*.json"))
    assert pom.sample_device_memory() is None
