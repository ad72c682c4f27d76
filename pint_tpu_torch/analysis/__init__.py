"""pint_tpu_torch.analysis — invariant enforcement for the port (a port
of pint_tpu/analysis, for the rules that mean something without jax).

Two layers:

- ``graftlint`` (+ ``concurrency``, ``lock_registry``, ``allowlist``):
  the AST/registry linter encoding the port's conventions as rules G1-G8
  and G12-G17 (``python -m pint_tpu_torch.analysis.graftlint``); the
  reference's dataflow half (G9-G11: ``graftflow``, ``cfg``,
  ``precision_registry``) has no target in the port yet (graftlint's
  module docstring says why);
- ``sanitizer``: the runtime ``Sanitizer`` context manager that counts
  per-TOAs device-cache builds per TimingModel (the "params_only must
  not rebuild" invariant), flags host-array operands crossing into
  CUDA dispatches (nested containers and opaque request objects
  included) and NaN-checks outputs.
"""

from pint_tpu_torch.analysis.sanitizer import Sanitizer  # noqa: F401

__all__ = ["Sanitizer", "lint_state", "lint_state_safe"]


def lint_state(root=None) -> dict:
    """Analyzer-state block for perf artifacts: a degraded-analysis
    state — violations in the tree, a bloated suppression surface — is
    labeled in the artifact itself, like degraded dispatch already is
    (the supervisor's counters). Static rules only: the dynamic zoo
    half belongs to the test gate."""
    from pint_tpu_torch.analysis import graftlint
    from pint_tpu_torch.analysis.allowlist import ALLOWLIST

    if root is None:
        root = graftlint.find_repo_root(__file__)
    report = graftlint.run_lint(root, dynamic=False)
    # ALLOWLIST-stale findings can be artifacts of skipping the
    # dynamic half (an entry only the zoo checks hit); the lint GATE
    # judges staleness, the artifact label judges the code
    real = [v for v in report.violations if v.rule != "ALLOWLIST"]
    return {
        "clean": not real,
        "violations": len(real),
        "suppressed": len(report.suppressed),
        "allowlist_entries": len(ALLOWLIST),
        "rules": len(graftlint.RULES),
        "static_only": True,
    }


def lint_state_safe() -> dict:
    """lint_state that never raises — a broken analyzer yields
    {"clean": None, "error": ...} instead of killing the record that
    embeds it."""
    try:
        return lint_state()
    except Exception as e:
        return {"clean": None, "error": repr(e)}
