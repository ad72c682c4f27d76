"""Finds every piece of a cell by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json`` (it names its ``system``,
the module under ``systems/`` that builds it) with its plain reference in
``reference/<config>.py``; a traffic mix is ``traffic/<mix>.json`` (it
names its ``driver`` under ``drivers/``); an end-to-end metric is read by
``end_to_end/<metric>.py`` and a per-layer metric by
``layer_metrics/<metric>.py``. A later cell, mix or metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def module(kind: str, name: str):
    """The module in ``<kind>/<name>.py``, loaded by its path (names may
    hold '-' and '.', which an import statement cannot spell)."""
    path = HERE / kind / f"{name}.py"
    key = "portbench._" + kind + "." + re.sub(r"[^0-9A-Za-z_]", "_", name)
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell_name: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it under ``workloads``, and those
    without the key that move (or, end to end, are) a metric the cell
    reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if section == "end_to_end":
        return [m for m in spec["end_to_end"] if m["name"] in e2e]
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
