"""graftlint — project-specific invariant linter for pint_tpu_torch (a
port of pint_tpu/analysis/graftlint.py; it walks ``pint_tpu_torch/``,
and rule G6(a) also ``chip_smoke.py``).

The conventions of the port that nothing enforced mechanically: the
lock discipline of the serve stack, counters through the metrics
registry, env knobs through ``config.py``, dispatches through the
runtime supervisor, and no host sync inside the float64 compute paths.
One silent host round trip, unsupervised device call, or stray global
switch corrupts a result or a wall without failing a test.

Rules. **Unchanged in meaning from the reference**: G3, G4, G5, G8, G12,
G13, G14, G16 and G17. **Re-meant for eager torch**: G1/G2, G6(b), G7 and
G15. **Not ported**: G9 (precision demotions; it comes with the opt-in
float32 routes, whose demotion sites it checks), G10 (parameter values
baked as trace constants: eager torch traces nothing) and
G11 (use-after-donate: the port records buffer donation as off).

  G1  no host sync (float/int/bool/complex coercion, .item/.tolist/
      .cpu/.numpy) inside a compute path: a function whose early
      positional parameters include ``pv`` (the parameter-value dict
      every component compute method takes), a function handed to a
      torch.func transform (vmap/jacfwd/jacrev/grad/...), and what they
      call in their module. In eager torch each one stalls the stream
      until the card catches up, and makes the step impossible to
      capture as a CUDA graph
  G2  no numpy calls in models/ compute paths — np.* on a tensor hauls
      it to the host (a sync) or fails on a CUDA tensor
  G3  every registered Component subclass cites its reference
      file/symbol in the class docstring
  G4  every numeric parameter slot has a param_dimensions() spec
      (static: the class must define/inherit an override; dynamic:
      bare instances and the SINK_PAR kitchen-sink model must have
      full _spec_lookup coverage; the dynamic half imports the port's
      registry on the CPU)
  G5  hybrid-Jacobian claims are paired (linear_design_names defined
      iff linear_design_local is) and every claiming component is
      exercised by test_all_components.py's SINK_PAR sweep
  G6  (a) scripts/ and chip_smoke.py: subprocess calls pass timeout=
      and Popen is not used bare (a child stuck on a wedged card hangs
      its parent); (b) the production dispatch layer (fitter/gls/
      wideband_fitter/config + serve/ + parallel/ + sampling/ + pta/):
      a *device program* — any callable some call site hands to
      ``DispatchSupervisor.dispatch``/``dispatch_async`` — must not be
      CALLED directly there: route it through the supervisor, which
      owns the watchdog deadline / breaker / host-failover policy.
      Sanctioned internal sites (calls inside the dispatched closure)
      carry pragmas or allowlist entries
  G7  the process-global torch switches (set_default_dtype/_device/
      _tensor_type, backends.cuda.matmul.allow_tf32,
      backends.cudnn.allow_tf32, set_float32_matmul_precision,
      use_deterministic_algorithms) only in the package root, config.py
      and this linter: a stray switch mid-library flips float32 matmul
      precision or the default dtype under every other caller
  G8  no functools.lru_cache/cache on methods (the cache keys `self`
      — a model leak — and any tensor arg is hashed by object id)
  G12 supervised-dispatch call sites in the dispatch layer (the G6
      file set) must run under a tracer span context
      (``pint_tpu_torch.obs.span``/``attach``): the supervisor's
      dispatch span and its retry/timeout/breaker/failover children
      parent from the ambient context, so a dispatch issued with no
      span context is a causal orphan. Compliance is approximate: the
      call must be lexically under a ``with ...span(...)`` /
      ``attach(...)``, or its enclosing function (or a lexical
      ancestor) must be reachable from a span-bearing function via
      same-module calls
  G13 no ad-hoc counter mutation in the dispatch/serve layer (the G6
      file set): an attribute/dict INCREMENT on counter-named state
      bypasses the ``obs.metrics`` registry, so the value would be
      invisible to /metrics, the SLO watchdog and the
      registry-vs-snapshot parity oracle. Mutate through a bound
      registry child (``.inc()``) or the owning class's ``bump()``
  G14 health taps flow through ``HealthMonitor.observe``: (a)
      ``pint_tpu_health_*`` registry metrics may be created only inside
      pint_tpu_torch/obs/health.py; (b) in the dispatch layer, a
      function that reads a health vector (an ``hv``-named binding or
      an "hv" signal key) must hand it to a ``.observe(...)`` call
  G15 profiler control and FLOP-count probes only in the perf plane:
      ``torch.profiler.profile``/``torch.autograd.profiler.profile``,
      ``torch.cuda.profiler.start``/``stop`` and ``FlopCounterMode``
      may appear only in pint_tpu_torch/obs/perf.py and
      pint_tpu_torch/profiling.py. torch's profiler is thread-local
      and the perf plane gives each window its own thread: a stray
      profiler elsewhere collides with those windows, and an ad-hoc
      FLOP probe escapes the once-per-key ledger
  G16 lock discipline over the dispatch layer + runtime/ + obs/ +
      scripts/ against analysis/lock_registry.py (the dynamic mirror is
      ``runtime.locks`` under $PINT_TPU_LOCK_TRACE): raw
      ``threading.Lock/RLock/Condition`` construction goes through the
      ``runtime.locks`` factories; registry-GUARDED fields are written
      only under their lock; SCRAPE_ROOTS are statically unreachable
      from any ENGINE_LOCKS acquisition; no supervised dispatch,
      journal fsync/admit/ack or host solve under an engine lock
  G17 no raw ``os.environ`` / ``os.getenv`` outside
      pint_tpu_torch/config.py: every env knob reads through a
      validated config parser (warn-and-ignore on bad values).
      Whole-environment subprocess passthroughs
      (``env=dict(os.environ)``) are sanctioned per site with a pragma

Compute reachability is inferred statically, seeded by project
conventions: any function whose early positional parameters include
``pv``, any function named as an argument of a torch.func transform
anywhere in the scanned tree, and the transitive closure over
same-module calls (``self.helper(...)`` / ``helper(...)``) plus lexical
containment (closures defined inside a compute function).

Suppression: a central allowlist (pint_tpu_torch/analysis/allowlist.py,
every entry carries a written justification) or an inline pragma
``# graftlint: allow G<n> -- reason`` on the flagged line. Stale
allowlist entries are themselves errors, so the list cannot rot.

Run: ``python -m pint_tpu_torch.analysis.graftlint [--root DIR] [--json]
[--format json] [--changed-only] [--no-dynamic]``. Exit 0 = clean. The
repo-clean gate is tests/test_torch_graftlint.py::test_repo_clean
(``pytest -m lint tests/test_torch_graftlint.py``).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

PKG = "pint_tpu_torch"

RULES = {
    "G1": "no host sync (scalar coercion, .item/.tolist/.cpu/.numpy) in "
          "pv compute paths",
    "G2": "no numpy host calls in models/ compute paths",
    "G3": "component class docstring must cite its reference",
    "G4": "every numeric parameter needs a param_dimensions spec",
    "G5": "linear-design claims paired and exercised by SINK_PAR",
    "G6": "subprocesses of scripts/ and chip_smoke.py timeout-bounded; "
          "dispatch-layer device programs called only through the "
          "runtime supervisor",
    "G7": "process-global torch switches only in sanctioned entry "
          "points",
    "G8": "no functools.lru_cache on methods",
    "G12": "supervised-dispatch call sites must run under a tracer "
           "span context (obs.span/attach) so dispatch telemetry "
           "has a causal parent",
    "G13": "no ad-hoc counter mutation in the dispatch/serve layer "
           "outside the obs.metrics registry",
    "G14": "health taps read through HealthMonitor.observe: "
           "pint_tpu_health_* metrics only in obs/health.py, and "
           "dispatch-layer health vectors must reach an observe()",
    "G15": "torch profiler control and FlopCounterMode probes only in "
           "obs/perf.py / profiling.py (the supervised window facility "
           "and the once-per-key compile ledger)",
    "G16": "lock discipline in the dispatch/serve/runtime/obs "
           "layers: locks constructed through runtime.locks "
           "factories, registry-guarded fields written only under "
           "their lock, scrape paths statically unreachable from "
           "engine-lock acquisition, and no dispatch/fsync/host "
           "solve under an engine lock "
           "(analysis/lock_registry.py)",
    "G17": "no raw os.environ/os.getenv outside pint_tpu_torch/config.py "
           "— env knobs read through validated config parsers; "
           "subprocess whole-env passthroughs pragma-sanctioned",
}

# entry points allowed to flip process-global torch switches (G7): the
# package root, the config module, and this linter's own CLI
G7_SANCTIONED = {
    f"{PKG}/__init__.py",
    f"{PKG}/config.py",
    f"{PKG}/analysis/graftlint.py",
}
# torch.<fn>(...) calls that mutate process-global state
G7_SWITCH_CALLS = {"set_default_dtype", "set_default_device",
                   "set_default_tensor_type",
                   "set_float32_matmul_precision",
                   "use_deterministic_algorithms"}
# torch.backends.<...>.allow_tf32 = ... assignments
G7_SWITCH_ATTRS = {"allow_tf32"}

# component compute-path method convention: a compute function's early
# positional params include the pv dict; host methods never take pv
PV_PARAM = "pv"
PV_WINDOW = 3  # pv must appear among the first 3 positional params

# torch.func transforms: the function handed in runs per call on
# device tensors (and under vmap, on batched tensors)
TRANSFORMS = {"vmap", "jacfwd", "jacrev", "grad", "grad_and_value",
              "hessian", "jvp", "vjp", "linearize", "functional_call"}

COERCIONS = {"float", "int", "bool", "complex"}
COERCION_METHODS = {"item", "tolist", "cpu", "numpy"}

NUMERIC_PARAM_CTORS = {"floatParameter", "MJDParameter",
                       "prefixParameter", "maskParameter",
                       "pairParameter", "AngleParameter", "floatParam"}

# abstract bases never instantiated by users (mirrors
# tests/test_all_components.py's abstract set)
ABSTRACT_COMPONENTS = {"Component", "DelayComponent", "PhaseComponent",
                       "NoiseComponent"}

SUBPROCESS_CALLS = {"run", "check_output", "check_call", "call"}

PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*allow\s+(G\d+)\s*(?:--|—|:)\s*(\S.*)")


@dataclass
class Violation:
    rule: str
    path: str        # repo-relative, forward slashes
    line: int
    msg: str
    snippet: str = ""
    # "file": anchored to one file's content; "repo": a repo-global
    # fact (stale allowlist/registry entries, dynamic zoo findings)
    # that --changed-only must never filter away
    scope: str = "file"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{self.rule} {loc}: {self.msg}"
        if self.snippet:
            out += f"\n    {self.snippet.strip()}"
        return out


@dataclass
class LintReport:
    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Tuple[Violation, str]] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def clean(self) -> bool:
        return not self.violations


# --------------------------------------------------------------------
# file collection
# --------------------------------------------------------------------

# files outside the package that G6(a) reads (and nothing else)
G6_EXTRA_FILES = ("chip_smoke.py",)


def iter_lint_files(root: str):
    """(abspath, relpath) for every file graftlint owns: the package
    tree, plus chip_smoke.py for G6(a)."""
    skip_dirs = {"__pycache__", ".git", "csrc"}
    base = os.path.join(root, PKG)
    if os.path.isdir(base):
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in skip_dirs)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = os.path.join(dirpath, fn)
                    yield p, os.path.relpath(p, root).replace(os.sep, "/")
    for rel in G6_EXTRA_FILES:
        p = os.path.join(root, rel)
        if os.path.isfile(p):
            yield p, rel


# --------------------------------------------------------------------
# per-module model
# --------------------------------------------------------------------

class ModuleInfo:
    """Parsed module + parent links + function/class indexes."""

    def __init__(self, relpath: str, src: str):
        self.relpath = relpath
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=relpath)
        # every node, in ast.walk order: the module-wide scans of the
        # rules iterate this list instead of walking the tree again
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.functions: List[ast.FunctionDef] = []
        self.classes: List[ast.ClassDef] = []
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)
            elif isinstance(node, ast.ClassDef):
                self.classes.append(node)
        self.by_name: Dict[str, List[ast.FunctionDef]] = {}
        for f in self.functions:
            self.by_name.setdefault(f.name, []).append(f)
        self.compute_funcs: Set[ast.FunctionDef] = set()

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_class(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_compute_region(self, node: ast.AST) -> bool:
        cur = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
            else self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and cur in self.compute_funcs:
                return True
            cur = self.parents.get(cur)
        return False


def _tail_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def collect_compute_seed_names(
        modules: List[ModuleInfo]) -> Dict[str, Set[str]]:
    """relpath -> function NAMES passed (possibly nested, e.g.
    vmap(jacfwd(f)), or bound by functools.partial) to a torch.func
    transform. Names harvested in a module seed that module; names that
    follow the _private convention additionally seed every module (a
    private kernel may be transformed where it is imported). Public
    names deliberately do NOT cross modules — `f`/`fn` collide with
    unrelated host helpers everywhere."""
    per_module: Dict[str, Set[str]] = {}
    global_private: Set[str] = set()

    def harvest(call: ast.Call, names: Set[str]):
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(a, (ast.Name, ast.Attribute)):
                t = _tail_name(a)
                if t and t != "torch":
                    names.add(t)
            elif isinstance(a, ast.Call):
                f = a.func
                if _tail_name(f) in TRANSFORMS or \
                        _tail_name(f) == "partial":
                    harvest(a, names)

    for m in modules:
        names: Set[str] = set()
        for node in m.nodes:
            if isinstance(node, ast.Call) and \
                    _tail_name(node.func) in TRANSFORMS:
                harvest(node, names)
        names -= TRANSFORMS
        per_module[m.relpath] = names
        global_private |= {n for n in names if n.startswith("_")}
    for relpath in per_module:
        per_module[relpath] |= global_private
    return per_module


def mark_compute_regions(m: ModuleInfo, global_seed_names: Set[str]):
    """Seed + fixpoint propagation of compute reachability (module
    doc)."""
    comp: Set[ast.FunctionDef] = set()
    for f in m.functions:
        args = [a.arg for a in f.args.args[:PV_WINDOW + 1]]
        if PV_PARAM in args:
            comp.add(f)
        if f.name in global_seed_names:
            comp.add(f)
    # propagate: calls from compute bodies to same-module functions, by
    # bare name or self./cls. attribute — but a callee name locally
    # bound in the caller (parameter, assignment, loop target) is a
    # local callable, NOT the module function of the same name
    changed = True
    while changed:
        changed = False
        for f in list(comp):
            local = _locally_bound_names(f)
            for node in ast.walk(f):
                if not isinstance(node, ast.Call):
                    continue
                callee = None
                fn = node.func
                if isinstance(fn, ast.Name):
                    if fn.id in local:
                        continue
                    callee = fn.id
                elif isinstance(fn, ast.Attribute) and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id in ("self", "cls"):
                    callee = fn.attr
                if callee is None:
                    continue
                for g in m.by_name.get(callee, []):
                    if g not in comp:
                        comp.add(g)
                        changed = True
    m.compute_funcs = comp


def _locally_bound_names(f: ast.FunctionDef) -> Set[str]:
    """Names bound inside ``f`` (params, assignments, loop/with/comp
    targets) — shadowing any same-named module function."""
    out = {a.arg for a in f.args.args + f.args.kwonlyargs}
    out.update(a.arg for a in (f.args.vararg, f.args.kwarg) if a)
    for node in ast.walk(f):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                               ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, ast.comprehension):
            targets = [node.target]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            targets = [i.optional_vars for i in node.items
                       if i.optional_vars is not None]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out


# --------------------------------------------------------------------
# G1 / G2 — host syncs and numpy in compute paths
# --------------------------------------------------------------------

HOST_ATTRS = {"value", "uncertainty", "frozen", "index", "units",
              "name", "prefix", "ndim", "size", "ref_day", "shape",
              "dtype", "device"}
HOST_ROOT_MODULES = {"math", "os", "sys"}
# frozen_value is the sanctioned host read of a frozen param
# (models/timing_model.py), so coercing ITS result is host arithmetic
HOST_CALLS = {"len", "str", "repr", "ord", "range", "frozen_value"}


def _is_host_expr(node: ast.AST) -> bool:
    """Conservatively: does this expression provably involve only
    host (non-tensor) data? Unknown names are NOT host — device
    tensors flow through locals."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        if node.attr in HOST_ATTRS:
            return True
        return _root_name(node) in HOST_ROOT_MODULES
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in HOST_CALLS:
            return True
        if isinstance(f, ast.Attribute) and \
                _root_name(f) in HOST_ROOT_MODULES:
            return True
        return False
    if isinstance(node, ast.BinOp):
        return _is_host_expr(node.left) and _is_host_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_host_expr(node.operand)
    if isinstance(node, ast.Subscript):
        return _is_host_expr(node.value)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_host_expr(e) for e in node.elts)
    if isinstance(node, ast.BoolOp):
        return all(_is_host_expr(v) for v in node.values)
    if isinstance(node, ast.IfExp):
        return _is_host_expr(node.body) and _is_host_expr(node.orelse)
    return False


def check_g1(m: ModuleInfo) -> List[Violation]:
    out = []
    for node in m.nodes:
        if not isinstance(node, ast.Call) or \
                not m.in_compute_region(node):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in COERCIONS:
            if node.args and _is_host_expr(node.args[0]):
                continue
            out.append(Violation(
                "G1", m.relpath, node.lineno,
                f"{fn.id}() inside compute path "
                f"{_region_name(m, node)} coerces a potentially "
                f"device-resident value to a Python scalar (a host sync "
                f"that stalls the stream and breaks graph capture)",
                m.line_text(node.lineno)))
        elif isinstance(fn, ast.Attribute) and \
                fn.attr in COERCION_METHODS and not node.args and \
                not _is_host_expr(fn.value):
            out.append(Violation(
                "G1", m.relpath, node.lineno,
                f".{fn.attr}() inside compute path "
                f"{_region_name(m, node)} copies a potentially "
                f"device-resident tensor to the host (a sync that "
                f"breaks graph capture)", m.line_text(node.lineno)))
    return out


def _region_name(m: ModuleInfo, node: ast.AST) -> str:
    f = m.enclosing_function(node)
    return f"`{f.name}`" if f is not None else "module code"


def check_g2(m: ModuleInfo) -> List[Violation]:
    if "/models/" not in "/" + m.relpath:
        return []
    out = []
    for node in m.nodes:
        if not isinstance(node, ast.Call) or \
                not m.in_compute_region(node):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                _root_name(fn) in ("np", "numpy"):
            out.append(Violation(
                "G2", m.relpath, node.lineno,
                f"numpy call np.{fn.attr}() inside compute path "
                f"{_region_name(m, node)}: on a tensor this is a host "
                f"round trip (a sync) or an error on the card",
                m.line_text(node.lineno)))
    return out


# --------------------------------------------------------------------
# G3 / G4(static) / G5(static) — the component zoo, via a global
# class graph (components subclass bases imported from other modules)
# --------------------------------------------------------------------

class ClassGraph:
    def __init__(self, modules: List[ModuleInfo]):
        self.defs: Dict[str, Tuple[ModuleInfo, ast.ClassDef]] = {}
        for m in modules:
            for c in m.classes:
                self.defs.setdefault(c.name, (m, c))
        self.component_classes = self._closure("Component")

    def _closure(self, root: str) -> Set[str]:
        comp = {root}
        changed = True
        while changed:
            changed = False
            for name, (m, c) in self.defs.items():
                if name in comp:
                    continue
                bases = {b.id if isinstance(b, ast.Name)
                         else _tail_name(b) for b in c.bases}
                if bases & comp:
                    comp.add(name)
                    changed = True
        return comp

    def is_registered_component(self, name: str) -> bool:
        if name not in self.component_classes or \
                name in ABSTRACT_COMPONENTS or name.startswith("_"):
            return False
        m, c = self.defs[name]
        for node in c.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "register" \
                            and isinstance(node.value, ast.Constant) \
                            and node.value.value is False:
                        return False
        return True

    def defines_in_body(self, name: str, method: str) -> bool:
        m, c = self.defs[name]
        return any(isinstance(n, ast.FunctionDef) and n.name == method
                   for n in c.body)

    def ancestors(self, name: str) -> List[str]:
        out, todo = [], [name]
        while todo:
            cur = todo.pop()
            if cur not in self.defs:
                continue
            _, c = self.defs[cur]
            for b in c.bases:
                bn = b.id if isinstance(b, ast.Name) else _tail_name(b)
                if bn and bn not in out:
                    out.append(bn)
                    todo.append(bn)
        return out

    def defines_or_inherits(self, name: str, method: str) -> bool:
        for cand in [name] + self.ancestors(name):
            if cand == "Component":
                continue  # the base's empty default doesn't count
            if cand in self.defs and self.defines_in_body(cand, method):
                return True
        return False


def _registers_numeric_params(graph: ClassGraph, name: str) -> bool:
    """Does this class (or an ancestor) construct numeric Parameter
    objects anywhere in its body (init, setup, add_* helpers)?"""
    for cand in [name] + graph.ancestors(name):
        if cand not in graph.defs or cand == "Component":
            continue
        _, c = graph.defs[cand]
        for node in ast.walk(c):
            if isinstance(node, ast.Call) and \
                    _tail_name(node.func) in NUMERIC_PARAM_CTORS:
                return True
    return False


def check_g3(graph: ClassGraph) -> List[Violation]:
    out = []
    for name, (m, c) in sorted(graph.defs.items()):
        if not graph.is_registered_component(name):
            continue
        doc = ast.get_docstring(c) or ""
        if not re.search(r"[Rr]eference", doc):
            out.append(Violation(
                "G3", m.relpath, c.lineno,
                f"component {name} does not cite its reference "
                f"file/symbol in the class docstring",
                f"class {name}(...):"))
    return out


def check_g4_static(graph: ClassGraph) -> List[Violation]:
    out = []
    for name, (m, c) in sorted(graph.defs.items()):
        if not graph.is_registered_component(name):
            continue
        if not _registers_numeric_params(graph, name):
            continue
        if not graph.defines_or_inherits(name, "param_dimensions"):
            out.append(Violation(
                "G4", m.relpath, c.lineno,
                f"component {name} registers numeric parameters but "
                f"neither defines nor inherits a param_dimensions() "
                f"spec (units go dimension-unchecked)",
                f"class {name}(...):"))
    return out


def check_g5_static(graph: ClassGraph) -> List[Violation]:
    out = []
    for name, (m, c) in sorted(graph.defs.items()):
        if name not in graph.component_classes or name == "Component":
            continue
        has_names = graph.defines_in_body(name, "linear_design_names")
        has_local = graph.defines_in_body(name, "linear_design_local")
        if has_names != has_local:
            missing = ("linear_design_local" if has_names
                       else "linear_design_names")
            out.append(Violation(
                "G5", m.relpath, c.lineno,
                f"component {name} defines one hybrid-Jacobian hook "
                f"but not {missing}: claims and columns must be "
                f"declared together", f"class {name}(...):"))
    return out


# --------------------------------------------------------------------
# G6 — timeout bounds in scripts/ and chip_smoke.py; device programs
# through the supervisor in the dispatch layer
# --------------------------------------------------------------------

def _g6_applies(relpath: str) -> bool:
    return "/scripts/" in relpath or relpath in G6_EXTRA_FILES


# the production dispatch layer: every device call here must route
# through runtime.DispatchSupervisor (runtime/ itself is the supervisor
# — exempt by construction). Host-side exploration tools (mcmc,
# bayesian, templates, gridutils, pintk) are deliberately outside the
# set: they are interactive analysis surfaces, not the serving/fitting
# path.
G6_DISPATCH_FILES = {f"{PKG}/fitter.py", f"{PKG}/gls.py",
                     f"{PKG}/wideband_fitter.py", f"{PKG}/config.py"}
G6_DISPATCH_DIRS = (f"{PKG}/serve/", f"{PKG}/parallel/",
                    f"{PKG}/sampling/", f"{PKG}/pta/")


def _g6_dispatch_applies(relpath: str) -> bool:
    if relpath.startswith(f"{PKG}/runtime/"):
        return False
    return relpath in G6_DISPATCH_FILES or \
        relpath.startswith(G6_DISPATCH_DIRS)


def _is_supervised_dispatch(node: ast.AST) -> bool:
    """``<supervisor>.dispatch(...)``/``.dispatch_async(...)``."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr in DISPATCH_METHODS and \
        bool(_expr_names(node.func.value) & SUPERVISOR_MARKERS)


def collect_device_programs(modules: List[ModuleInfo]):
    """Names of DEVICE PROGRAMS: the callable (first positional
    argument) of every supervised ``dispatch``/``dispatch_async`` call
    site in the dispatch layer — the supervisor calls it under its
    watchdog, so the name is a device dispatch wherever it is called.
    Private names are shared across modules; public names (``run``,
    ``call``) stay module-local, as with the compute-path seeds."""
    per_module: Dict[str, Set[str]] = {}
    global_private: Set[str] = set()
    for m in modules:
        names: Set[str] = set()
        if _g6_dispatch_applies(m.relpath):
            for node in m.nodes:
                if _is_supervised_dispatch(node) and node.args:
                    t = _tail_name(node.args[0])
                    if t:
                        names.add(t)
        per_module[m.relpath] = names
        global_private |= {n for n in names if n.startswith("_")}
    return per_module, global_private


def check_g6_dispatch(m: ModuleInfo,
                      programs: Set[str]) -> List[Violation]:
    """Dispatch-layer half of G6: direct CALLS of device programs
    bypass the runtime supervisor's watchdog/breaker/failover policy —
    on a wedged card that is an unbounded hang. Passing the program as
    an argument (supervisor.dispatch(run, ...)) is the sanctioned route
    and is not a call, so it never flags."""
    if not _g6_dispatch_applies(m.relpath):
        return []
    out = []
    for node in m.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        tail = _tail_name(fn)
        if tail not in programs:
            continue
        # flag bare names AND any attribute chain ending in a program
        # name (self._run, eng.cache._solve, ...) — a known limit: a
        # local alias (k = self._k; k(x)) escapes this static check
        if isinstance(fn, (ast.Name, ast.Attribute)):
            out.append(Violation(
                "G6", m.relpath, node.lineno,
                f"direct call of device program `{tail}` (a callable "
                f"the supervisor dispatches) in the dispatch layer "
                f"bypasses the runtime supervisor (unbounded hang on a "
                f"wedged card) — pass it to DispatchSupervisor.dispatch "
                f"instead", m.line_text(node.lineno)))
    return out


# G12 — span context at supervised-dispatch call sites ---------------

# context managers that establish a span context (pint_tpu_torch.obs):
# span()/open_span() enter a new span, attach() re-enters a captured
# one on a worker thread — all three parent subsequent dispatch spans
SPAN_CONTEXT_CALLS = {"span", "attach"}
DISPATCH_METHODS = {"dispatch", "dispatch_async"}
# receiver-name markers identifying the callee as the runtime
# supervisor (sup.dispatch / self.supervisor.dispatch /
# get_supervisor().dispatch / supervisor.dispatch_async)
SUPERVISOR_MARKERS = {"supervisor", "sup", "get_supervisor"}


def _expr_names(node: ast.AST) -> Set[str]:
    """Every Name id / Attribute attr / called tail in an expression
    — how a dispatch call's receiver chain is matched against the
    supervisor markers."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _with_establishes_span(node) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and _tail_name(it.context_expr.func) in SPAN_CONTEXT_CALLS
        for it in node.items)


def _span_context_closure(m: ModuleInfo) -> Set[ast.FunctionDef]:
    """Functions that (approximately) run under a span context:
    seeds are functions whose body contains a with-span/with-attach
    statement; the closure propagates along same-module calls (bare
    name or self./cls. attribute) from a seed to its callees, with the
    same shadowed-local filtering as the compute-path inference."""
    seeds: Set[ast.FunctionDef] = set()
    for f in m.functions:
        for node in ast.walk(f):
            if _with_establishes_span(node):
                seeds.add(f)
                break
    ok = set(seeds)
    changed = True
    while changed:
        changed = False
        for f in list(ok):
            local = _locally_bound_names(f)
            for node in ast.walk(f):
                if not isinstance(node, ast.Call):
                    continue
                callee = None
                fn = node.func
                if isinstance(fn, ast.Name):
                    if fn.id in local:
                        continue
                    callee = fn.id
                elif isinstance(fn, ast.Attribute) and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id in ("self", "cls"):
                    callee = fn.attr
                if callee is None:
                    continue
                for g in m.by_name.get(callee, []):
                    if g not in ok:
                        ok.add(g)
                        changed = True
    return ok


def check_g12(m: ModuleInfo) -> List[Violation]:
    """Span context at supervised-dispatch call sites (module
    docstring G12). Same file set as G6's dispatch half; runtime/
    is exempt by construction (the supervisor IS the span emitter).
    """
    if not _g6_dispatch_applies(m.relpath):
        return []
    closure = None  # computed lazily — most modules have no dispatch
    out = []
    for node in m.nodes:
        if not _is_supervised_dispatch(node):
            continue
        fn = node.func
        # (a) lexically under a with-span/with-attach
        cur = m.parents.get(node)
        enclosed = False
        while cur is not None:
            if _with_establishes_span(cur):
                enclosed = True
                break
            cur = m.parents.get(cur)
        if enclosed:
            continue
        # (b) enclosing function (or a lexical ancestor — closures
        # the span-bearing function builds) in the span closure
        if closure is None:
            closure = _span_context_closure(m)
        cur = m.enclosing_function(node)
        in_closure = False
        while cur is not None:
            if cur in closure:
                in_closure = True
                break
            cur = m.enclosing_function(cur)
        if in_closure:
            continue
        out.append(Violation(
            "G12", m.relpath, node.lineno,
            f"supervised dispatch `{fn.attr}` with no span context: "
            f"the dispatch span (and its retry/timeout/breaker/"
            f"failover children) would be a causal orphan — wrap the "
            f"call site in `with obs.span(...)` (or obs.attach on a "
            f"worker thread)", m.line_text(node.lineno)))
    return out


# G13 — ad-hoc counter mutation outside obs.metrics ------------------

# the counter vocabulary of the serve/dispatch stack: every name
# that is (or was) a counter in the supervisor / serve metrics /
# admission / router / bucket-stats / AOT-store snapshot blocks.
# Kept explicit so a NEW counter name must be added here when its
# class grows one — at which point the rule starts protecting it.
G13_COUNTER_NAMES = frozenset({
    # runtime supervisor
    "dispatches", "guarded", "retries", "timeouts",
    "transient_errors", "failovers", "breaker_rejections",
    "breaker_recoveries", "abandoned_workers", "rtt_remeasures",
    "async_dispatches",
    # serve engine
    "submitted", "completed", "rejected", "failed",
    "deadline_missed", "fallback_single",
    # admission
    "shed_expired", "shed_deadline", "shed_quota", "shed_overload",
    "shed_shutdown", "shed_bursts", "injected_overload",
    "admitted", "shed", "acked",
    # router pools
    "demotions", "requests", "rows",
    # bucket stats
    "batches", "slots", "rows_real", "rows_padded",
    # AOT store / journal / flight
    "exported", "restored", "export_errors", "restore_errors",
    "hits", "misses", "replayed", "compactions", "dumps",
    "suppressed",
    # streaming GLS / append serving
    "chunk_dispatches", "cg_solves", "cold_builds", "rank_updates",
    # numerical health
    "health_incidents", "shadow_replays", "shadow_drift_exceeded",
    "cg_budget_exhausted",
    # array GWB likelihood plane
    "gwb_solves", "block_assemblies", "hd_outer_solves",
    # serve fleet / journal hardening
    "rehomed", "lease_expiries", "worker_kills", "heartbeats",
    "torn_records",
})


def _g13_counterish(name: Optional[str]) -> bool:
    if not name:
        return False
    n = name.lstrip("_")
    return (n in G13_COUNTER_NAMES or n.endswith("_count")
            or n.endswith("_total") or "counter" in n)


def _g13_target_name(tgt: ast.AST) -> Optional[str]:
    """The counter-ish name an increment target resolves to:
    ``x.timeouts`` -> "timeouts"; ``d["shed"]`` -> "shed";
    ``self.counters[k]`` -> "counters" (the container name)."""
    if isinstance(tgt, ast.Attribute):
        return tgt.attr
    if isinstance(tgt, ast.Subscript):
        sl = tgt.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            if _g13_counterish(sl.value):
                return sl.value
        return _tail_name(tgt.value)
    return None


def check_g13(m: ModuleInfo) -> List[Violation]:
    """Ad-hoc counter mutation in the dispatch/serve layer (module
    docstring G13): ``x.failovers += 1`` / ``d["shed"] += 1`` /
    ``x.timeouts = x.timeouts + 1`` on counter-named state bypasses
    the obs.metrics registry. Plain local names are never flagged
    (loop tallies are not metrics), and only the G6 dispatch file
    set is in scope — obs/ and runtime/ are the plane itself."""
    if not _g6_dispatch_applies(m.relpath):
        return []
    out = []
    for node in m.nodes:
        tgt = None
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.op, ast.Add):
            tgt = node.target
        elif isinstance(node, ast.Assign) and \
                len(node.targets) == 1 and \
                isinstance(node.value, ast.BinOp) and \
                isinstance(node.value.op, ast.Add):
            # x.attr = x.attr + n / d[k] = d.get(k, 0) + n — flag
            # only the SELF-REFERENTIAL form (a fresh assignment of
            # a sum is not an increment)
            cand = node.targets[0]
            td = ast.unparse(cand)  # unparse: Load/Store ctx-blind
            selfref = any(
                (isinstance(sub, (ast.Attribute, ast.Subscript))
                 and ast.unparse(sub) == td) or (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "get"
                    and isinstance(cand, ast.Subscript)
                    and ast.unparse(sub.func.value)
                    == ast.unparse(cand.value))
                for sub in ast.walk(node.value))
            if selfref:
                tgt = cand
        if tgt is None or isinstance(tgt, ast.Name):
            continue
        name = _g13_target_name(tgt)
        if not _g13_counterish(name):
            continue
        out.append(Violation(
            "G13", m.relpath, node.lineno,
            f"ad-hoc increment of counter state `{name}` in the "
            f"dispatch/serve layer bypasses the obs.metrics "
            f"registry (invisible to /metrics, the SLO watchdog "
            f"and the parity oracle) — mutate through a bound "
            f"registry child (.inc()) or the owning bump()",
            m.line_text(node.lineno)))
    return out


# G14 — health taps flow through HealthMonitor.observe --------------

# the registry factory calls a stray health metric would ride
_G14_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_G14_PREFIX = "pint_tpu_health_"
G14_HOME = f"{PKG}/obs/health.py"


def _g14_hv_name(name: Optional[str]) -> bool:
    return bool(name) and (name == "hv" or name.startswith("hv_"))


def check_g14(m: ModuleInfo) -> List[Violation]:
    """Health-tap routing (module docstring G14). Two halves:

    (a) package-wide except obs/health.py itself:
    ``om.counter("pint_tpu_health_...")`` (or gauge/histogram)
    anywhere else mints a health metric the monitor's verdict
    machinery never sees;

    (b) dispatch layer only: a function binding/reading an ``hv``
    health vector must call ``.observe(...)`` somewhere in its body
    (a lexical approximation — a vector handed to a helper that
    observes escapes it)."""
    out = []
    if m.relpath != G14_HOME:
        for node in m.nodes:
            if not isinstance(node, ast.Call):
                continue
            if _tail_name(node.func) not in _G14_METRIC_FACTORIES:
                continue
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and \
                        isinstance(a.value, str) and \
                        a.value.startswith(_G14_PREFIX):
                    out.append(Violation(
                        "G14", m.relpath, node.lineno,
                        f"health metric {a.value!r} created outside "
                        f"{G14_HOME}: the monitor's thresholds/"
                        f"incident/flight machinery never sees it — "
                        f"record through HealthMonitor.observe "
                        f"instead", m.line_text(node.lineno)))
    if not _g6_dispatch_applies(m.relpath):
        return out
    for f in m.functions:
        if m.in_compute_region(f):
            # the PRODUCER side: compute kernels build the hv and
            # must not observe it themselves
            continue
        uses_hv = False
        observes = False
        todo = [f]
        while todo:
            cur = todo.pop()
            for node in ast.iter_child_nodes(cur):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        node is not f and node in m.compute_funcs:
                    continue  # nested PRODUCER kernel
                todo.append(node)
                if isinstance(node, ast.Name) and \
                        _g14_hv_name(node.id):
                    uses_hv = True
                elif isinstance(node, ast.Constant) and \
                        node.value == "hv":
                    uses_hv = True
                elif isinstance(node, ast.Call) and \
                        _tail_name(node.func) == "observe":
                    observes = True
        if uses_hv and not observes:
            # closure pattern: a nested dispatch closure may hand
            # the vector back to its builder, which observes — a
            # lexical ancestor's observe covers it
            cur = m.enclosing_function(f)
            while cur is not None and not observes:
                observes = any(
                    isinstance(n, ast.Call)
                    and _tail_name(n.func) == "observe"
                    for n in ast.walk(cur))
                cur = m.enclosing_function(cur)
        if uses_hv and not observes:
            out.append(Violation(
                "G14", m.relpath, f.lineno,
                f"`{f.name}` reads a health vector (hv) without "
                f"routing it through HealthMonitor.observe — ad-hoc "
                f"host math at the call site bypasses the validated "
                f"thresholds, registry recording, span event and "
                f"incident path", m.line_text(f.lineno)))
    return out


# G15 — profiler control and FLOP probes only in the perf plane ------

G15_SANCTIONED = {f"{PKG}/obs/perf.py", f"{PKG}/profiling.py"}
# <...profiler...>.<tail>(...): torch.profiler.profile,
# torch.autograd.profiler.profile, torch.cuda.profiler.start/stop
_G15_PROFILER_CALLS = {"profile", "start", "stop", "_KinetoProfile"}
_G15_PROFILER_MODULES = ("torch.profiler", "torch.autograd.profiler",
                         "torch.cuda.profiler")
_G15_COST_CALLS = {"FlopCounterMode"}


def _g15_bare_imports(m: ModuleInfo) -> Dict[str, str]:
    """Local names bound by ``from torch.profiler import profile`` (and
    the other profiler modules) or ``from ... import FlopCounterMode``
    -> the imported name."""
    out: Dict[str, str] = {}
    for n in m.nodes:
        if isinstance(n, ast.ImportFrom) and n.module:
            for a in n.names:
                if (n.module in _G15_PROFILER_MODULES
                        and a.name in _G15_PROFILER_CALLS) or \
                        a.name in _G15_COST_CALLS:
                    out[a.asname or a.name] = a.name
    return out


def check_g15(m: ModuleInfo) -> List[Violation]:
    """Profiler control + FLOP-count probes confined to the perf plane
    (module docstring G15). Package-wide minus the sanctioned files: a
    stray ``torch.profiler.profile`` in the serve layer collides with
    the perf plane's one-thread windows (torch's profiler is
    thread-local), and an ad-hoc ``FlopCounterMode`` probe escapes the
    once-per-key ledger dedup."""
    if m.relpath in G15_SANCTIONED:
        return []
    bare = _g15_bare_imports(m)
    out = []
    for node in m.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        tail = _tail_name(fn)
        if isinstance(fn, ast.Name) and fn.id in bare:
            tail = bare[fn.id]
            kind = "cost" if tail in _G15_COST_CALLS else "profiler"
        elif isinstance(fn, ast.Attribute) and tail in _G15_COST_CALLS:
            kind = "cost"
        elif isinstance(fn, ast.Attribute) and \
                tail in _G15_PROFILER_CALLS and \
                "profiler" in _expr_names(fn.value):
            kind = "profiler"
        else:
            continue
        if kind == "profiler":
            out.append(Violation(
                "G15", m.relpath, node.lineno,
                f"raw profiler control `{tail}` outside the perf "
                f"plane: torch's profiler is thread-local and the perf "
                f"plane gives each bounded, rate-limited window its own "
                f"thread — use obs.perf.request_window (or "
                f"profiling.trace for script-scoped attribution runs)",
                m.line_text(node.lineno)))
        else:
            out.append(Violation(
                "G15", m.relpath, node.lineno,
                f"{tail} FLOP probe outside the perf plane: probe "
                f"through obs.perf.note_compile/cost_probe so it runs "
                f"once per key (ledger dedup), never on a hot path",
                m.line_text(node.lineno)))
    return out


def check_g6_python(m: ModuleInfo) -> List[Violation]:
    """Timeout bounds on the subprocesses of scripts/ and
    chip_smoke.py: a child stuck on a wedged card hangs its parent
    with no error."""
    if not _g6_applies(m.relpath):
        return []
    out = []
    # `from subprocess import run [as r]` aliases
    sub_aliases: Dict[str, str] = {}
    for n in m.nodes:
        if isinstance(n, ast.ImportFrom) and n.module == "subprocess":
            for a in n.names:
                sub_aliases[a.asname or a.name] = a.name
    for node in m.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        tail = _tail_name(fn)
        sub_call = None
        if isinstance(fn, ast.Attribute) and \
                _root_name(fn) == "subprocess":
            sub_call = tail
        elif isinstance(fn, ast.Name) and fn.id in sub_aliases:
            sub_call = sub_aliases[fn.id]
        if sub_call == "Popen":
            out.append(Violation(
                "G6", m.relpath, node.lineno,
                "subprocess.Popen has no timeout bound of its own "
                "(.wait() hangs on a child stuck on a wedged card) — "
                "use subprocess.run(timeout=...)",
                m.line_text(node.lineno)))
        elif sub_call in SUBPROCESS_CALLS:
            if not any(kw.arg == "timeout" for kw in node.keywords):
                out.append(Violation(
                    "G6", m.relpath, node.lineno,
                    f"subprocess.{sub_call}() without timeout=: a "
                    f"child stuck on a wedged card hangs forever",
                    m.line_text(node.lineno)))
    return out


# --------------------------------------------------------------------
# G7 / G8
# --------------------------------------------------------------------

def check_g7(m: ModuleInfo) -> List[Violation]:
    """Process-global torch switches outside the sanctioned entry
    points: ``torch.set_default_dtype(...)`` & co. as calls (also
    through ``from torch import set_default_dtype``), and assignments
    to ``torch.backends.*.allow_tf32``."""
    if m.relpath in G7_SANCTIONED:
        return []
    bare = {a.asname or a.name for n in m.nodes
            if isinstance(n, ast.ImportFrom) and n.module == "torch"
            for a in n.names if a.name in G7_SWITCH_CALLS}
    out = []
    for node in m.nodes:
        hit = None
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in G7_SWITCH_CALLS and \
                    _root_name(fn) == "torch":
                hit = f"torch.{fn.attr}()"
            elif isinstance(fn, ast.Name) and fn.id in bare:
                hit = f"torch.{fn.id}()"
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and \
                        t.attr in G7_SWITCH_ATTRS and \
                        _root_name(t) == "torch":
                    hit = f"{ast.unparse(t)} = ..."
        if hit:
            out.append(Violation(
                "G7", m.relpath, node.lineno,
                f"{hit} outside sanctioned entry points "
                f"({PKG}/__init__.py, {PKG}/config.py): a process-"
                f"global torch switch changes dtype or matmul "
                f"precision under every other caller in-process",
                m.line_text(node.lineno)))
    return out


def check_g8(m: ModuleInfo) -> List[Violation]:
    out = []
    for f in m.functions:
        if m.enclosing_class(f) is None:
            continue
        args = f.args.args
        if not args or args[0].arg not in ("self", "cls"):
            continue
        for dec in f.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _tail_name(target) in ("lru_cache", "cache") and \
                    (_root_name(target) in ("functools", None) or
                     isinstance(target, ast.Name)):
                out.append(Violation(
                    "G8", m.relpath, f.lineno,
                    f"functools.{_tail_name(target)} on method "
                    f"`{f.name}`: caches `self` (leak) and hashes "
                    f"tensor args by id — use an explicit keyed cache "
                    f"like TimingModel.get_cache",
                    m.line_text(f.lineno)))
    return out


# --------------------------------------------------------------------
# dynamic (import-the-zoo) half of G4 / G5
# --------------------------------------------------------------------

def _load_sink_par(root: str) -> Optional[str]:
    p = os.path.join(root, "tests", "test_all_components.py")
    if not os.path.exists(p):
        return None
    with open(p, encoding="utf-8") as fh:
        mobj = re.search(r'SINK_PAR = """(.*?)"""', fh.read(), re.S)
    return mobj.group(1) if mobj else None


def dynamic_registry_checks(root: str) -> List[Violation]:
    """Imports the port's full component zoo (models built on the CPU)
    and checks G4 coverage + G5 exercise against the committed SINK_PAR,
    read out of tests/test_all_components.py as text. Separated so
    tests can run the AST half alone."""
    import warnings

    import pint_tpu_torch.models  # noqa: F401 — registry side effects
    import pint_tpu_torch.models.binary  # noqa: F401
    import pint_tpu_torch.models.components_extra  # noqa: F401
    import pint_tpu_torch.models.components_tail  # noqa: F401
    import pint_tpu_torch.models.noise  # noqa: F401
    import pint_tpu_torch.models.tcb_conversion  # noqa: F401
    from pint_tpu_torch.models.timing_model import component_types

    out: List[Violation] = []
    out += check_g4_dynamic(component_types)
    sink = _load_sink_par(root)
    if sink is None:
        out.append(Violation(
            "G5", "tests/test_all_components.py", 0,
            "SINK_PAR not found — the kitchen-sink sweep that "
            "exercises hybrid-Jacobian claims is missing"))
        return out
    import io

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from pint_tpu_torch.models import get_model

        model = get_model(io.StringIO(sink), device="cpu")
    out += check_g4_sink(model)
    out += check_g5_dynamic(component_types, model)
    return out


def _numeric_param_types():
    from pint_tpu_torch.models.parameter import (
        AngleParameter,
        MJDParameter,
        floatParameter,
        maskParameter,
        pairParameter,
        prefixParameter,
    )

    return (floatParameter, MJDParameter, prefixParameter,
            maskParameter, pairParameter, AngleParameter)


def check_g4_dynamic(component_types: dict) -> List[Violation]:
    """Bare-instance coverage: every numeric parameter registered at
    construction must resolve through _spec_lookup."""
    from pint_tpu_torch.units import _spec_lookup

    NUM = _numeric_param_types()
    out = []
    for name, cls in sorted(component_types.items()):
        if name in ABSTRACT_COMPONENTS:
            continue
        comp = cls()
        spec = comp.param_dimensions()
        missing = [p.name for p in comp.params.values()
                   if isinstance(p, NUM) and
                   _spec_lookup(spec, p.name) is None]
        if missing:
            out.append(Violation(
                "G4", _class_path(cls), 0,
                f"{name}.param_dimensions() does not cover "
                f"{missing} — units go dimension-unchecked"))
    return out


def check_g4_sink(model) -> List[Violation]:
    """SINK-model coverage: prefix/mask families only materialize at
    par parse, so the bare-instance check misses them."""
    from pint_tpu_torch.models.parameter import (
        boolParameter,
        intParameter,
        strParameter,
    )
    from pint_tpu_torch.units import _spec_lookup

    out = []
    for cname, comp in model.components.items():
        spec = comp.param_dimensions()
        missing = [p.name for p in comp.params.values()
                   if not isinstance(p, (strParameter, boolParameter,
                                         intParameter))
                   and _spec_lookup(spec, p.name) is None]
        if missing:
            out.append(Violation(
                "G4", _class_path(type(comp)), 0,
                f"{cname}.param_dimensions() does not cover the "
                f"SINK_PAR-materialized params {missing}"))
    return out


def check_g5_dynamic(component_types: dict, model) -> List[Violation]:
    """Every component class that implements hybrid-Jacobian claims
    must be exercised by the SINK_PAR sweep: present in the model and
    actually claiming at least one free parameter there."""
    out = []
    free = set(model.free_params)
    for name, cls in sorted(component_types.items()):
        if "linear_design_names" not in cls.__dict__:
            continue
        comp = model.components.get(name)
        if comp is None:
            out.append(Violation(
                "G5", _class_path(cls), 0,
                f"{name} implements linear_design_names but is not in "
                f"test_all_components.py's SINK_PAR — its claims are "
                f"never swept against the production fit step"))
            continue
        claims = set(comp.linear_design_names())
        if not claims:
            out.append(Violation(
                "G5", _class_path(cls), 0,
                f"{name} is in SINK_PAR but claims no free parameter "
                f"there — free one of its claimable params so the "
                f"sweep exercises the closed-form column"))
        elif not claims <= free:
            out.append(Violation(
                "G5", _class_path(cls), 0,
                f"{name} claims {sorted(claims - free)} which are not "
                f"free in the SINK model (claims must be free "
                f"params)"))
    return out


def _class_path(cls) -> str:
    mod = sys.modules.get(cls.__module__)
    f = getattr(mod, "__file__", None) or cls.__module__
    i = f.replace(os.sep, "/").rfind(f"{PKG}/")
    return f.replace(os.sep, "/")[i:] if i >= 0 else f


# --------------------------------------------------------------------
# suppression: pragmas + the committed allowlist
# --------------------------------------------------------------------

def apply_suppressions(report: LintReport, allowlist: List[dict],
                       sources: Dict[str, str]):
    """Drop violations covered by an inline pragma or an allowlist
    entry. An entry suppresses at most ``max_hits`` (default 1)
    violations — a NEW violation that happens to share the substring
    must surface for its own review, not ride an old justification.
    Stale entries (zero hits) become violations themselves."""
    hits = [0] * len(allowlist)
    kept: List[Violation] = []
    for v in report.violations:
        line = ""
        src = sources.get(v.path)
        if src is not None and v.line:
            lines = src.splitlines()
            if v.line <= len(lines):
                line = lines[v.line - 1]
        pragma = PRAGMA_RE.search(line)
        if pragma and pragma.group(1) == v.rule:
            report.suppressed.append((v, f"pragma: {pragma.group(2)}"))
            continue
        hit = None
        for i, e in enumerate(allowlist):
            if e["rule"] != v.rule or e["file"] != v.path:
                continue
            if hits[i] >= e.get("max_hits", 1):
                continue
            if e.get("match") and e["match"] not in (line or v.snippet
                                                     or v.msg):
                if e["match"] not in v.msg:
                    continue
            hits[i] += 1
            hit = e
            break
        if hit is not None:
            report.suppressed.append((v, f"allowlist: {hit['why']}"))
        else:
            kept.append(v)
    report.violations = kept
    for i, e in enumerate(allowlist):
        if not hits[i]:
            report.violations.append(Violation(
                "ALLOWLIST", e["file"], 0,
                f"stale allowlist entry (rule {e['rule']}, match "
                f"{e.get('match')!r}) no longer suppresses anything — "
                f"delete it so the list stays honest", scope="repo"))


# --------------------------------------------------------------------
# driver
# --------------------------------------------------------------------

def run_lint(root: str, dynamic: bool = True,
             use_allowlist: bool = True) -> LintReport:
    report = LintReport()
    modules: List[ModuleInfo] = []
    extra: List[ModuleInfo] = []
    sources: Dict[str, str] = {}
    for abspath, relpath in iter_lint_files(root):
        with open(abspath, encoding="utf-8") as fh:
            src = fh.read()
        sources[relpath] = src
        report.files_scanned += 1
        try:
            m = ModuleInfo(relpath, src)
        except SyntaxError as e:
            report.violations.append(Violation(
                "PARSE", relpath, e.lineno or 0, f"syntax error: {e}"))
            continue
        (extra if relpath in G6_EXTRA_FILES else modules).append(m)
    seed_names = collect_compute_seed_names(modules)
    prog_per_module, prog_private = collect_device_programs(modules)
    # the concurrency rule family (G16/G17) lives in
    # analysis/concurrency; imported lazily so AST fixtures in tests
    # can drive the halves standalone
    from pint_tpu_torch.analysis import concurrency as _conc

    g16_hits: Dict[int, int] = {}
    for m in modules:
        mark_compute_regions(m, seed_names.get(m.relpath, set()))
        report.violations += check_g1(m)
        report.violations += check_g2(m)
        report.violations += check_g6_python(m)
        report.violations += check_g6_dispatch(
            m, prog_per_module.get(m.relpath, set()) | prog_private)
        report.violations += check_g12(m)
        report.violations += check_g13(m)
        report.violations += check_g14(m)
        report.violations += check_g15(m)
        report.violations += check_g7(m)
        report.violations += check_g8(m)
        report.violations += _conc.check_g16(m, g16_hits)
        report.violations += _conc.check_g17(m)
    for m in extra:
        report.violations += check_g6_python(m)
    report.violations += _conc.g16_stale_entries(g16_hits)
    report.violations += _conc.check_g16_scrape_paths(modules)
    graph = ClassGraph(modules)
    report.violations += check_g3(graph)
    report.violations += check_g4_static(graph)
    report.violations += check_g5_static(graph)
    if dynamic:
        for v in dynamic_registry_checks(root):
            v.scope = "repo"
            report.violations.append(v)
    allow = []
    if use_allowlist:
        from pint_tpu_torch.analysis.allowlist import ALLOWLIST

        allow = ALLOWLIST
    apply_suppressions(report, allow, sources)
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return report


def changed_file_set(root: str) -> Set[str]:
    """Repo-relative paths changed vs HEAD (staged + unstaged +
    untracked) — the --changed-only scope. Bounded subprocesses (a
    repo on a wedged network mount must not hang the linter)."""
    import subprocess

    out: Set[str] = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others",
                  "--exclude-standard"]):
        try:
            r = subprocess.run(args, cwd=root, capture_output=True,
                               text=True, timeout=30)
        except Exception:
            continue
        if r.returncode == 0:
            out.update(p.strip() for p in r.stdout.splitlines()
                       if p.strip())
    return out


def find_repo_root(start: Optional[str] = None) -> str:
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(cur, PKG)):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            raise SystemExit(
                f"graftlint: no {PKG}/ package found above cwd "
                f"(pass --root)")
        cur = parent


def github_annotation(v: Violation) -> str:
    """One GitHub Actions ``::error`` workflow-command line for a
    violation (%/CR/LF escaped per the workflow-command spec;
    repo-scope findings pin to line 1 so the annotation renders)."""
    msg = f"{v.rule}: {v.msg}".replace(
        "%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    return (f"::error file={v.path},line={max(1, v.line)},"
            f"title=graftlint {v.rule}::{msg}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {PKG}.analysis.graftlint",
        description="the port's invariant linter (rules "
                    + ", ".join(RULES) + ")")
    ap.add_argument("--root", default=None,
                    help=f"repo root (default: walk up to {PKG}/)")
    ap.add_argument("--json", action="store_true",
                    help="single-document machine-readable output")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text",
                    help="json: one {file,line,rule,msg} record per "
                         "line (JSONL) plus a trailing summary "
                         "record; github: `::error file=..,line=..::..` "
                         "workflow-annotation lines")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only findings in files changed vs "
                         "HEAD (git diff + untracked) — the fast "
                         "pre-commit mode; repo-global findings "
                         "(stale allowlist/registry entries, "
                         "dynamic zoo checks) are kept. The full run "
                         "remains the gate")
    ap.add_argument("--no-dynamic", action="store_true",
                    help="skip the import-the-zoo half of G4/G5")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report suppressed findings too")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rid, desc in RULES.items():
            print(f"{rid}  {desc}")
        return 0
    root = args.root or find_repo_root(os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    changed = None
    if args.changed_only:
        changed = changed_file_set(root)
        scanned = {rel for _, rel in iter_lint_files(root)}
        # the dynamic zoo half is repo-global and slow; in the fast
        # pre-commit mode run it only when model/test structure moved
        zoo_trigger = any(c.startswith(f"{PKG}/models/") or
                          c.startswith("tests/") for c in changed)
        if not (changed & scanned) and not zoo_trigger:
            if args.format == "json":
                print(json.dumps({"summary": True, "clean": True,
                                  "files_scanned": 0, "violations": 0,
                                  "changed_only": True}))
            elif args.format == "text":
                print("graftlint: no lintable files changed")
            return 0
        if not zoo_trigger:
            args.no_dynamic = True
    report = run_lint(root, dynamic=not args.no_dynamic,
                      use_allowlist=not args.no_allowlist)
    if changed is not None:
        # repo-scope findings (stale allowlist/registry entries, the
        # dynamic zoo checks) survive the filter: they are facts about
        # the tree, not about unchanged files
        report.violations = [v for v in report.violations
                             if v.path in changed or
                             v.scope == "repo"]
    if args.format == "github":
        for v in report.violations:
            print(github_annotation(v))
        return 0 if report.clean else 1
    if args.format == "json":
        for v in report.violations:
            print(json.dumps({"file": v.path, "line": v.line,
                              "rule": v.rule, "msg": v.msg}))
        print(json.dumps({"summary": True, "clean": report.clean,
                          "files_scanned": report.files_scanned,
                          "violations": len(report.violations),
                          "suppressed": len(report.suppressed),
                          "rules": len(RULES),
                          "changed_only": bool(args.changed_only)}))
        return 0 if report.clean else 1
    if args.json:
        print(json.dumps({
            "clean": report.clean,
            "files_scanned": report.files_scanned,
            "violations": [v.__dict__ for v in report.violations],
            "suppressed": [
                {**v.__dict__, "reason": why}
                for v, why in report.suppressed],
        }, indent=2))
    else:
        for v in report.violations:
            print(v.format())
        print(f"graftlint: {report.files_scanned} files, "
              f"{len(report.violations)} violation(s), "
              f"{len(report.suppressed)} suppressed")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
