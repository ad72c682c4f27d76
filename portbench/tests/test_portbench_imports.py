"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name, and the references import nothing of the
program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pint_tpu"}


def top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not top_imports(path) & (FORBIDDEN | {"pint_tpu_torch",
                                                 "portbench"})


def test_check_compares_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    for name in FORBIDDEN:
        mods.pop(name, None)
    mods.update({"pint_tpu_torch": object(), "pint_tpu_torch.pta": object(),
                 "jaxtyping": object(), "flaxen.x": object()})
    monkeypatch.setattr(sys, "modules", mods)
    assert run.loaded_forbidden() == []
    mods["pint_tpu.models"] = object()
    mods["jaxlib"] = object()
    assert run.loaded_forbidden() == ["jaxlib", "pint_tpu"]


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process, JAX made unimportable: it
    completes, and nothing forbidden is loaded after it."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'pint_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import torch\n"
        "from portbench import registry, run\n"
        "from portbench.tests.conftest import small_gwb\n"
        "spec = registry.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    out = run.run_cell(spec, w, 5, 0.2, False,"
        " torch.device('cpu'), small_gwb())\n"
        "    assert out['correct'], out\n"
        "for n in ('jax', 'jaxlib', 'flax', 'pint_tpu'):\n"
        "    del sys.modules[n]\n"
        "print(run.loaded_forbidden())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
