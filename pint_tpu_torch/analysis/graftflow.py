"""graftflow — dataflow precision analysis, rule G9 (a port of the G9
half of pint_tpu/analysis/graftflow.py).

The bug class graftlint's per-node rules cannot see, because it is a
*dataflow* property: a silent float32 demotion reaching the dd
error-free-transform chain. The residual path runs float64 dd, and only
the engineered boundaries of the opt-in precision routes (the fit step's
``jac_f32`` and ``matmul_f32`` sites, the dd32 split primitives) may
demote. graftflow tracks a small dtype-provenance lattice {dd, f64, f32,
unknown} through assignments, calls and returns (``analysis.cfg``) and
enforces:

(a) every syntactic demotion — ``.to(torch.float32)``, ``.float()``,
    ``.type(torch.float32)``, ``.astype(np.float32)``, ``dtype=
    torch.float32`` constructions, ``np.float32(...)`` literals, the
    ``"float32"`` string spellings, and the dd32 converters
    (``dd_to_dd32``, ``f64_to_dd32``, ``_tree_to32``, ``_split32``) —
    matches a justified entry of ``analysis/precision_registry.py``;
    stale entries fail, and each entry's declared gate is checked
    against the enclosing ``if`` or the enclosing function's
    parameters;
(b) inside the exact-precision modules (``models/timing_model.py``,
    ``residuals.py``, ``gls.py``) no ``ops/dd.py``/``ops/dd_np.py``
    consumer receives a float32-provenance value;
(c) mixed known-float32 x known-float64 arithmetic is a demotion site
    like any other.

Scope. Eager torch has no trace boundary: any function of the package
may run on the card, so G9 reads every function (the reference reads
its jit-reachable ones), except the linter's own ``analysis/`` modules,
which spell dtypes as data. A function without a demotion call can
carry no float32 provenance (the analysis is intraprocedural and starts
each function with unknown parameters), so the dataflow pass runs only
where one occurs.

Differential validation: ``predict_profile(**flags)`` gives, for each
``precision_registry.PROBES`` entry, whether the probed boundary fires
and with which dtype under a route assignment;
``Sanitizer.dtype_probe`` records what a built step actually does, and
tests/test_torch_graftflow.py asserts the two agree.

Not ported: G10 (parameter values baked as trace constants) and G11
(use after buffer donation). Eager torch traces nothing, so a parameter
value read in a compute function is read afresh at every call, and the
port records buffer donation as off; both return only with a traced or
donating path (a ``torch.compile`` route would bring G10 back).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from pint_tpu_torch.analysis import cfg as _cfg
from pint_tpu_torch.analysis import graftlint as _gl
from pint_tpu_torch.analysis import precision_registry as _reg

Violation = _gl.Violation

__all__ = ["run_flow_checks", "predict_profile", "check_g9_module",
           "demotion_kind", "registry_stale_violations", "verify_probes",
           "FlowContext"]

# ---------------------------------------------------------- lattice

F32 = "f32"       # float32 provenance: demoted somewhere upstream
F64 = "f64"       # known plain float64 (an explicit upcast)
DDV = "dd"        # double-double pair
UNKNOWN = "unknown"


def join_dtype(a: str, b: str) -> str:
    if a == b:
        return a
    if F32 in (a, b):
        return F32   # the taint survives every join
    return UNKNOWN


# dd-consumer protection zone: the exact-precision chain
PROTECTED_MODULES = {f"{_gl.PKG}/models/timing_model.py",
                     f"{_gl.PKG}/residuals.py", f"{_gl.PKG}/gls.py"}

DD32_CONVERTERS = {"dd_to_dd32", "f64_to_dd32", "_tree_to32", "_split32"}

# dtype-cast methods whose arguments name the target dtype
CAST_METHODS = {"to", "type", "astype"}

# the linter's own modules spell dtypes as data, not as demotions
SKIP_PREFIX = f"{_gl.PKG}/analysis/"


class FlowContext:
    """What the per-module checks share: the registry and its hit
    counts, and the suppressed (registry-sanctioned) findings."""

    def __init__(self, modules, registry: Optional[List[dict]] = None):
        self.modules = modules
        self.registry = _reg.DEMOTIONS if registry is None else registry
        self.registry_hits = [0] * len(self.registry)
        self.suppressed: List[Tuple[Violation, str]] = []


# ------------------------------------------------------------------
# demotion sites
# ------------------------------------------------------------------

def _mentions_dtype(node: ast.AST, name: str) -> bool:
    """torch.float32 / np.float32 / bare float32 and the string spelling
    "float32" (``astype("float32")`` is common numpy idiom)."""
    for n in ast.walk(node):
        if isinstance(n, (ast.Attribute, ast.Name)) and \
                _gl._tail_name(n) == name:
            return True
        if isinstance(n, ast.Constant) and n.value == name:
            return True
    return False


def demotion_kind(node: ast.Call) -> Optional[str]:
    """Classify a call as a precision demotion, or None."""
    tail = _gl._tail_name(node.func)
    if tail in CAST_METHODS and isinstance(node.func, ast.Attribute) and \
            any(_mentions_dtype(a, "float32") for a in
                list(node.args) + [kw.value for kw in node.keywords]):
        return f"{tail}(float32)"
    if tail == "float" and isinstance(node.func, ast.Attribute) and \
            not node.args and not node.keywords:
        return ".float()"
    if tail in DD32_CONVERTERS:
        return f"{tail}()"
    if tail == "float32" and (node.args or node.keywords):
        return "float32(...) literal"
    # dtype-typed constructors: torch.as_tensor(x, dtype=torch.float32),
    # torch.zeros(n, dtype="float32"), np.full(..., dtype=np.float32)
    for kw in node.keywords:
        if kw.arg == "dtype" and _mentions_dtype(kw.value, "float32"):
            return "dtype=float32 construction"
    for a in node.args[1:]:
        if (isinstance(a, (ast.Attribute, ast.Name)) and
                _gl._tail_name(a) == "float32") or \
                (isinstance(a, ast.Constant) and a.value == "float32"):
            return "f32-dtype argument"
    return None


def _is_upcast(node: ast.Call) -> bool:
    """``.to(torch.float64)``, ``.double()``, ``.astype(np.float64)``:
    float64 values, but no laundering of a float32 provenance."""
    tail = _gl._tail_name(node.func)
    if not isinstance(node.func, ast.Attribute):
        return False
    if tail == "double" and not node.args:
        return True
    return tail in CAST_METHODS and any(
        _mentions_dtype(a, "float64") for a in
        list(node.args) + [kw.value for kw in node.keywords])


def _registry_lookup(ctx: FlowContext, relpath: str, func: str,
                     line_text: str) -> Optional[dict]:
    for i, e in enumerate(ctx.registry):
        if e["file"] != relpath or e["func"] != func:
            continue
        if e.get("match") and e["match"] not in line_text:
            continue
        if ctx.registry_hits[i] >= e.get("max_hits", 1):
            continue
        ctx.registry_hits[i] += 1
        return e
    return None


def _guard_satisfied(m: "_gl.ModuleInfo", node: ast.AST,
                     guard: str) -> bool:
    """The declared gate must actually gate the site: the node sits in
    the TRUE branch of an enclosing ``if <guard>...`` (a demotion in the
    else-branch runs exactly when the flag is off; ``if not <guard>``
    inverts the branches), or an enclosing function takes the gate as a
    parameter (the ``_symm_mm`` pattern)."""
    prev, cur = node, m.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If) and guard in ast.unparse(cur.test):
            negated = (isinstance(cur.test, ast.UnaryOp) and
                       isinstance(cur.test.op, ast.Not))
            in_body = any(prev is s for s in cur.body)
            in_else = any(prev is s for s in cur.orelse)
            if (in_body and not negated) or (in_else and negated):
                return True
            # the wrong branch: an outer guard may still gate it
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params = {a.arg for a in cur.args.args + cur.args.kwonlyargs}
            if guard in params:
                return True
        prev, cur = cur, m.parents.get(cur)
    return False


def _dd_consumer_names(m: "_gl.ModuleInfo") -> Set[str]:
    """Names this module imports from ops.dd / ops.dd_np (plus the
    ``dd_np.x`` attribute form): the consumers G9 protects."""
    out: Set[str] = set()
    for node in m.nodes:
        if isinstance(node, ast.ImportFrom) and node.module and \
                ("ops.dd" in node.module or node.module.endswith(".ops")):
            for a in node.names:
                out.add(a.asname or a.name)
    out.discard("dd_np")  # attribute calls are handled separately
    return out


# ------------------------------------------------------------------
# the dtype-provenance pass
# ------------------------------------------------------------------

class _DtypeFlow:
    """Per-function dtype-provenance pass (the cfg client).
    ``protected`` switches on the dd-consumer check (the exact-precision
    modules); mixed-dtype arithmetic flags everywhere."""

    def __init__(self, m, fn, consumers: Set[str], ctx: FlowContext,
                 record: Optional[List[Violation]] = None,
                 protected: bool = True):
        self.m = m
        self.fn = fn
        self.consumers = consumers
        self.ctx = ctx
        self.record = record
        self.protected = protected

    def eval(self, node: ast.AST, env: Dict[str, str]) -> str:
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Name):
            return env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Constant):
            return UNKNOWN  # Python scalars are weakly typed in torch
        if isinstance(node, ast.Attribute):
            # x.hi / x.lo keep x's provenance; anything else is a fresh
            # unknown unless the base is tainted
            base = self.eval(node.value, env)
            return base if base == F32 else (
                base if node.attr in ("hi", "lo") else UNKNOWN)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.BinOp):
            lt = self.eval(node.left, env)
            rt = self.eval(node.right, env)
            if {lt, rt} == {F32, F64} and self.record is not None:
                line = self.m.line_text(node.lineno)
                entry = _registry_lookup(self.ctx, self.m.relpath,
                                         self.fn.name, line)
                v = Violation(
                    "G9", self.m.relpath, node.lineno,
                    f"mixed float32 x float64 arithmetic in "
                    f"`{self.fn.name}`: the float32 operand already lost "
                    f"the bits the float64 side carries — demote only at "
                    f"a registered boundary", line)
                if entry is not None:
                    self.ctx.suppressed.append(
                        (v, f"registry: {entry['why']}"))
                else:
                    self.record.append(v)
            return join_dtype(lt, rt)
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand, env)
        if isinstance(node, ast.IfExp):
            return join_dtype(self.eval(node.body, env),
                              self.eval(node.orelse, env))
        if isinstance(node, (ast.Tuple, ast.List)):
            out = UNKNOWN
            for i, e in enumerate(node.elts):
                t = self.eval(e, env)
                out = t if i == 0 else join_dtype(out, t)
            return out
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.eval(node.value, env)
        return UNKNOWN

    def _eval_call(self, node: ast.Call, env) -> str:
        tail = _gl._tail_name(node.func)
        args = list(node.args) + [kw.value for kw in node.keywords]
        arg_ts = [self.eval(a, env) for a in args]
        joined = UNKNOWN
        for i, t in enumerate(arg_ts):
            joined = t if i == 0 else join_dtype(joined, t)
        if isinstance(node.func, ast.Attribute):
            # a method call on a tainted receiver stays tainted:
            # x.reshape(-1)/.sum()/.flatten() must not launder it
            joined = join_dtype(joined, self.eval(node.func.value, env))
        if demotion_kind(node):
            return F32
        if _is_upcast(node):
            # an upcast gives float64 values but does not launder a
            # float32 provenance: the bits are already gone
            base = self.eval(node.func.value, env)
            return F32 if base == F32 else F64
        if self.record is not None and self.protected and (
                tail in self.consumers or
                (isinstance(node.func, ast.Attribute) and
                 _gl._root_name(node.func) == "dd_np")):
            bad = [i for i, t in enumerate(arg_ts) if t == F32]
            if bad:
                line = self.m.line_text(node.lineno)
                self.record.append(Violation(
                    "G9", self.m.relpath, node.lineno,
                    f"dd consumer `{tail}` in an exact-precision module "
                    f"receives float32-provenance argument(s) {bad} "
                    f"inside `{self.fn.name}`: the dd error-free "
                    f"transforms assume full-precision inputs "
                    f"(demotions belong at the registered boundaries of "
                    f"parallel/fit_step)", line))
        if tail in ("dd", "DD", "dd_from_parts"):
            return F32 if joined == F32 else DDV
        # the taint propagates through any call: zeros_like(f32),
        # cat([f32, ...]), helper(f32) all stay float32-provenance
        return F32 if joined == F32 else UNKNOWN

    # ------------------------------------------------------ transfer

    def transfer(self, st: ast.stmt, env: Dict[str, str],
                 is_header: bool):
        if is_header:
            if isinstance(st, (ast.For, ast.AsyncFor)):
                t = self.eval(st.iter, env)
                for n in ast.walk(st.target):
                    if isinstance(n, ast.Name):
                        env[n.id] = t
            elif isinstance(st, (ast.If, ast.While)):
                self.eval(st.test, env)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    t = self.eval(item.context_expr, env)
                    if item.optional_vars is not None:
                        for n in ast.walk(item.optional_vars):
                            if isinstance(n, ast.Name):
                                env[n.id] = t
            return
        if isinstance(st, ast.Assign):
            t = self.eval(st.value, env)
            for tgt in st.targets:
                self._bind(tgt, st.value, t, env)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            self._bind(st.target, st.value, self.eval(st.value, env), env)
        elif isinstance(st, ast.AugAssign):
            t = join_dtype(self.eval(st.target, env),
                           self.eval(st.value, env))
            if isinstance(st.target, ast.Name):
                env[st.target.id] = t
        elif isinstance(st, ast.Expr):
            self.eval(st.value, env)
        elif isinstance(st, ast.Return) and st.value is not None:
            self.eval(st.value, env)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            env[st.name] = UNKNOWN
        elif isinstance(st, ast.Raise) and st.exc is not None:
            self.eval(st.exc, env)

    def _bind(self, tgt, value_node, t: str, env):
        if isinstance(tgt, ast.Name):
            env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            # element-wise when the right side is a literal tuple, else
            # the joined provenance lands on every target
            if isinstance(value_node, (ast.Tuple, ast.List)) and \
                    len(value_node.elts) == len(tgt.elts):
                for sub_t, sub_v in zip(tgt.elts, value_node.elts):
                    self._bind(sub_t, sub_v, self.eval(sub_v, env), env)
            else:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        env[n.id] = t


def _run_dtype_pass(m, fn, consumers, ctx,
                    protected: bool) -> List[Violation]:
    graph = _cfg.build_cfg(fn)
    flow = _DtypeFlow(m, fn, consumers, ctx, protected=protected)
    in_envs = _cfg.run_dataflow(graph, {}, flow.transfer, join_dtype)
    found: List[Violation] = []
    rec = _DtypeFlow(m, fn, consumers, ctx, record=found,
                     protected=protected)
    for b in graph.blocks:
        env = dict(in_envs.get(b.bid, {}))
        for st in b.stmts:
            rec.transfer(st, env, st in b.headers)
    return found


def check_g9_module(m: "_gl.ModuleInfo", ctx: FlowContext
                    ) -> List[Violation]:
    """The demotion-site scan (registry-sanctioned) plus the dtype pass
    (dd-consumer taint in the exact-precision modules, mixed
    arithmetic everywhere) over every function holding a demotion."""
    out: List[Violation] = []
    if m.relpath.startswith(SKIP_PREFIX):
        return out
    tainted: Set[ast.AST] = set()
    for node in m.nodes:
        if not isinstance(node, ast.Call):
            continue
        kind = demotion_kind(node)
        if not kind:
            continue
        fn = m.enclosing_function(node)
        if fn is not None:
            tainted.add(fn)
        fname = fn.name if fn is not None else "<module>"
        line = m.line_text(node.lineno)
        entry = _registry_lookup(ctx, m.relpath, fname, line)
        if entry is None:
            out.append(Violation(
                "G9", m.relpath, node.lineno,
                f"precision demotion [{kind}] in `{fname}` outside the "
                f"precision-boundary registry — if this demotion is "
                f"engineered and safe, declare it in "
                f"analysis/precision_registry.py with its "
                f"justification", line))
            continue
        guard = entry.get("guard")
        if guard and not _guard_satisfied(m, node, guard):
            out.append(Violation(
                "G9", m.relpath, node.lineno,
                f"registered boundary site declares guard `{guard}` "
                f"(flag {entry.get('flag')!r}) but the site is not in "
                f"the TRUE branch of an enclosing `if {guard}` and no "
                f"enclosing function takes `{guard}` as a parameter — "
                f"the registry's gating claim drifted from the code",
                line))
        else:
            v = Violation("G9", m.relpath, node.lineno,
                          f"demotion [{kind}] in `{fname}`", line)
            ctx.suppressed.append((v, f"registry: {entry['why']}"))
    protected = m.relpath in PROTECTED_MODULES
    consumers = _dd_consumer_names(m) if protected else set()
    for fn in m.functions:
        if fn in tainted:
            out.extend(_run_dtype_pass(m, fn, consumers, ctx, protected))
    return out


# ------------------------------------------------------------------
# registry hygiene
# ------------------------------------------------------------------

def registry_stale_violations(ctx: FlowContext) -> List[Violation]:
    out = []
    for i, e in enumerate(ctx.registry):
        if not ctx.registry_hits[i]:
            out.append(Violation(
                "REGISTRY", e["file"], 0,
                f"stale precision-registry entry (func {e['func']!r}, "
                f"match {e.get('match')!r}) no longer covers any "
                f"demotion site — delete it so the registry stays "
                f"honest", scope="repo"))
    return out


def verify_probes(modules, probes: Optional[List[dict]] = None
                  ) -> List[Violation]:
    """Every runtime probe must still point at a real call site in its
    declared file (the static half of the differential loop)."""
    probes = _reg.PROBES if probes is None else probes
    by_path = {m.relpath: m for m in modules}
    out = []
    for p in probes:
        m = by_path.get(p["file"])
        if m is None:
            continue  # fixture runs do not carry the real tree
        called = any(isinstance(n, ast.Call) and
                     _gl._tail_name(n.func) == p["callee"]
                     for n in m.nodes)
        if not called:
            out.append(Violation(
                "REGISTRY", p["file"], 0,
                f"dtype-probe {p['label']!r} points at `{p['callee']}` "
                f"but nothing in the file calls it any more — the "
                f"differential validation lost a site; update "
                f"precision_registry.PROBES", scope="repo"))
    return out


# ------------------------------------------------------------------
# prediction (the static half of the differential validation)
# ------------------------------------------------------------------

def _eval_flag(expr: Optional[str], flags: Dict[str, object]):
    if expr is None:
        return None
    # registry-authored expressions over four booleans, not user input:
    # the empty builtins keep it a pure flag calculus
    return eval(expr, {"__builtins__": {}}, dict(flags))  # noqa: S307


def predict_profile(jac32: bool = False, f32mm: bool = False,
                    anchored: bool = False, hybrid: bool = False
                    ) -> Dict[str, dict]:
    """{probe label: {"active": bool, "dtype": str | None}} under a
    route assignment. ``hybrid`` means "hybrid Jacobian on AND the model
    claims columns" (the caller owns that conjunction: an empty claim set
    never calls the column assembler)."""
    flags = dict(jac32=bool(jac32), f32mm=bool(f32mm),
                 anchored=bool(anchored), hybrid=bool(hybrid))
    out: Dict[str, dict] = {}
    for p in _reg.PROBES:
        active = bool(_eval_flag(p["flag"], flags))
        out[p["label"]] = {
            "active": active,
            "dtype": _eval_flag(p.get("dtype"), flags) if active else None,
        }
    return out


# ------------------------------------------------------------------
# entry point
# ------------------------------------------------------------------

def run_flow_checks(modules, registry: Optional[List[dict]] = None,
                    verify_probe_sites: bool = True):
    """(violations, suppressed) of G9 and the registry's hygiene over
    parsed ``graftlint.ModuleInfo`` modules."""
    ctx = FlowContext(modules, registry=registry)
    violations: List[Violation] = []
    for m in modules:
        violations += check_g9_module(m, ctx)
    violations += registry_stale_violations(ctx)
    if verify_probe_sites:
        violations += verify_probes(modules)
    return violations, ctx.suppressed
