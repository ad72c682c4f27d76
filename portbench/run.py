"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A run makes its inputs from the seed, builds
the system under test (the PyTorch/CUDA port, ``pint_tpu_torch``), warms
the shapes the cell's traffic uses, drives the traffic for ``--seconds``,
and then compares what the timed calls returned with the plain reference.
Its last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a short profiled
window after the timed one), ``device`` and, last, ``compared``: each
number compared with its limit, also the last lines on standard error.

A run needs a CUDA card; without one it exits with code 3 and prints no
result. It exits with code 4, and prints no result, when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``pint_tpu`` is among the loaded
modules once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
CACHE = os.path.join(CHECKOUT, ".portbench-cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pint_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (/proc), 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()


def pin_environment():
    """Kernel caches at fixed paths inside the checkout; load from one
    process with one thread for the numeric libraries (the host paces a
    third of each call; PERF.md gives the spreads); and the port at its
    defaults: no ``PINT_TPU_*`` knob of the caller's environment. Called
    before torch or numpy is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    for k in [k for k in os.environ if k.startswith("PINT_TPU_")]:
        del os.environ[k]


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is one the port must not use,
    compared whole (``pint_tpu_torch`` is not ``pint_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit_w():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            override: dict = None, mix_override: dict = None,
            device_window: bool = False) -> SimpleNamespace:
    """Set-up, warm-up, the timed window and, with ``trace``, a profiled
    window of the mix's ``trace_calls`` calls; the program's state is
    freed at the end, after the device's memory peak is read. With
    ``device_window`` (an end-to-end metric read from the device, on a
    card) every call of the timed window runs under a device-only
    profiler session (``trace.DeviceBusy``), the warm-up too, so that the
    profiler's start-up is set-up. Returns what the run drove: the
    system, the timed and traced calls, the window's device-busy seconds,
    the traced window and the memory peak. The look for a card is the
    caller's (``main``), so the tests can drive this on the CPU at a size
    of their own (``override`` replaces configuration keys and
    ``mix_override`` traffic keys)."""
    import torch

    from portbench import registry
    from portbench import trace as trace_mod

    seed = int(seed) % 2 ** 63  # the seeders take non-negative integers
    cfg = dict(registry.config(cell["config"]), **(override or {}))
    mix = dict(registry.traffic(cell["traffic"]), **(mix_override or {}))
    system_mod = registry.module("systems", cfg["system"])
    driver_mod = registry.module("drivers", mix["driver"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    system = system_mod.build(cfg, seed, device)
    driver = driver_mod.Driver(system, mix, seed)
    clock = trace_mod.DeviceBusy(sync) if device_window and cuda else None
    if clock:
        clock.run(driver.warm)
        clock.busy_s()
    else:
        driver.warm()
    sync()
    setup_s = _AGE0 + (time.perf_counter() - _T0)
    calls = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        calls.append(clock.run(driver.call) if clock else driver.call())
    elapsed = time.perf_counter() - start
    window_busy_s = clock.busy_s() if clock else None
    traced, tcalls, counters = None, [], {}
    if trace:
        before = system.counters()

        def traced_calls():
            for _ in range(mix["trace_calls"]):
                with torch.profiler.record_function("portbench.call"):
                    tcalls.append(driver.traced_call())

        traced = trace_mod.profile(traced_calls, sync)
        after = system.counters()
        counters = {k: after[k] - before.get(k, 0) for k in after}
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    system.release()
    return SimpleNamespace(
        seed=seed, cfg=cfg, system=system, system_mod=system_mod,
        ref=registry.module("reference", cfg["name"]), calls=calls,
        elapsed=elapsed, window_busy_s=window_busy_s, setup_s=setup_s,
        traced=traced, tcalls=tcalls, counters=counters, peak=peak)


def run_cell(spec: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, override: dict = None,
             mix_override: dict = None) -> dict:
    """The cell's run on ``device`` (see ``execute``); returns the result
    object."""
    import torch

    from portbench import registry

    e2e = registry.cell_metrics(spec, cell["name"], "end_to_end")
    device_window = not trace and any(m["source"] == "device_trace"
                                      for m in e2e)
    r = execute(cell, seed, seconds, trace, device, override, mix_override,
                device_window)
    gaps = r.system_mod.check(r.system, r.calls + r.tcalls, r.ref, r.cfg,
                              r.seed, device)
    compared = {name: {"value": gaps.get(name), "limit": limit}
                for name, limit in r.cfg["limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values())

    if trace:
        section, kind = "per_layer", "layer_metrics"
        ctx = {"trace": r.traced, "dims": r.system.dims,
               "points": sum(c["points"] for c in r.tcalls),
               "counters": r.counters, "calls": r.calls,
               "elapsed_s": r.elapsed}
    else:
        section, kind = "end_to_end", "end_to_end"
        ctx = {"calls": r.calls, "elapsed_s": r.elapsed,
               "setup_s": r.setup_s, "window_busy_s": r.window_busy_s}
    metrics = {}
    for m in registry.cell_metrics(spec, cell["name"], section):
        v = registry.module(kind, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": r.peak}
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    out = {"correct": bool(correct),
           "attempted": sum(c["points"] for c in r.calls),
           "failed": sum(c["points"] for c in r.calls if not c["ok"]),
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=r.traced.busy_s, window_s=r.traced.window_s,
                   launches=r.traced.launches)
        out["breakdown"] = r.traced.breakdown()
    out["compared"] = compared
    return out


def report(out: dict) -> None:
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    pin_environment()
    import torch

    from portbench import registry

    spec = registry.load_spec()
    cell = registry.cell(spec, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA card(s);"
              " found none usable", file=sys.stderr)
        return 3
    out = run_cell(spec, cell, a.seed, a.seconds, bool(a.trace),
                   torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the port must not use "
              "JAX or the JAX package", file=sys.stderr)
        return 4
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
