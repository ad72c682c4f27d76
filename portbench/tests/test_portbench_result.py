"""The last line's schema, from whole small runs on the CPU, and the
refusals of a run that cannot measure."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import registry, run
from portbench.tests.conftest import small_of

SPEC = registry.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(name, trace):
    cell = registry.cell(SPEC, name)
    out = run.run_cell(SPEC, cell, 2 ** 31 + 3, 0.3, bool(trace),
                       torch.device("cpu"), *small_of(name))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in registry.cell_metrics(SPEC, name, section)}
    assert set(out["metrics"]) <= names
    if not trace:
        # the CPU gives no device trace: a metric read from the device
        # over the window is left out
        assert set(out["metrics"]) == names - {
            m["name"] for m in SPEC["end_to_end"]
            if m["source"] == "device_trace"}
    else:
        # the CPU gives no device trace: only the counters and the host
        # clock are read
        assert set(out["metrics"]) == names - {
            m["name"] for m in SPEC["per_layer"]
            if m["source"] == "device_trace"}
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_padded_share_is_the_chunk_padding(small):
    cell = registry.cell(SPEC, "ng15-gwb-sampler")
    out = run.run_cell(SPEC, cell, 9, 0.2, True, torch.device("cpu"), small)
    assert out["metrics"]["padded_share.gwb"]["value"] == 1 - 1 / 8


def test_no_card_no_result():
    """Without a CUDA card the command exits with code 3 and prints no
    result line."""
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO / ".portbench-cache")})
    assert res.returncode == 3
    assert res.stdout.strip() == ""


def test_any_whole_seed_runs(small):
    """Seeds past 32 bits and below zero make inputs like any other."""
    cell = registry.cell(SPEC, "ng15-gwb-sampler")
    for seed in (-7, 2 ** 33 + 1):
        assert run.run_cell(SPEC, cell, seed, 0.1, False,
                            torch.device("cpu"), small)["correct"]


def test_device_busy_adds_the_unions_of_its_sessions():
    """A window's device-busy seconds: each session's intervals merged
    where they overlap, the sessions' totals added, and the sessions
    dropped once read."""
    from portbench import trace

    class Stub(trace.DeviceBusy):
        @staticmethod
        def _intervals(prof):
            return prof

    clock = Stub(lambda: None)
    clock.sessions = [[(0.0, 1.0), (0.5, 1.5), (2.0, 2.25)],
                      [(10.0, 10.5)], []]
    assert clock.busy_s() == 1.5 + 0.25 + 0.5
    assert clock.busy_s() == 0.0
