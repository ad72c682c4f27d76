"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by its name."""

import json
import re

import pytest

from portbench import registry

SPEC = registry.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert registry.SPEC.stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_command_stays_inside_paths():
    cmd = SPEC["command"]
    assert len(cmd) <= 32 and SPEC["paths"] == ["portbench"]
    assert cmd[:2] == ["python3", "-m"]
    assert cmd[2].split(".")[0] == "portbench"
    assert all(not w.startswith("/") and ".." not in w for w in cmd)


def test_names_units_and_lines():
    seen = set()
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[sec]:
            assert NAME.match(e["name"]), e["name"]
            assert (sec, e["name"]) not in seen
            seen.add((sec, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and sec != "end_to_end" and sec != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = registry.config(c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
    system = registry.module("systems", cfg["system"])
    assert all(callable(getattr(system, k, None))
               for k in ("build", "check", "control"))
    assert (registry.HERE / "reference" / f"{c['name']}.py").is_file()
    assert cfg["limits"] and cfg["precision"] == "float64"
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    mix = registry.traffic(w["traffic"])
    drv = registry.module("drivers", mix["driver"])
    assert all(hasattr(drv.Driver, k)
               for k in ("warm", "call", "traced_call"))
    e2e = [m["name"] for m in registry.cell_metrics(SPEC, w["name"],
                                                    "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.cell_metrics(SPEC, w["name"], "per_layer")


@pytest.mark.parametrize("m", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert callable(registry.module("end_to_end", m["name"]).read)


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    assert 1 <= len(m["layer"]) <= 200
    assert callable(registry.module("layer_metrics", m["name"]).read)
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m["workloads"]) <= cells
    for w in m["workloads"]:
        moved = registry.cell_metrics(SPEC, w, "end_to_end")
        assert m["moves"] in [e["name"] for e in moved]
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_bound():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25


def test_check_budget_fits_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_spec_is_json_with_no_stray_keys():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in SPEC["end_to_end"] else {"layer",
                                                               "moves"}
        assert set(m) <= allowed, m
    json.dumps(SPEC)
