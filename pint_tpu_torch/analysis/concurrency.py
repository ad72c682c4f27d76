"""Concurrency lint — graftlint rules G16 (lock discipline) and G17
(validated-env enforcement), a port of pint_tpu/analysis/concurrency.py
over the port's tree; the meaning of both rules is the reference's. The
dynamic half is ``runtime.locks`` (TracedLock + the process lock-order
graph).

G16, over the dispatch layer (the G6 file set) + ``runtime/`` +
``obs/`` + the serve CLI, checks four properties against
``analysis/lock_registry.py`` (every entry justified, stale entries
fail the run — the precision_registry policy):

- **G16.0 raw primitives**: ``threading.Lock()`` / ``RLock()`` /
  ``Condition()`` construction must go through the
  ``runtime.locks`` factories (``make_lock``/``make_rlock``/
  ``make_condition``) so the $PINT_TPU_LOCK_TRACE build sees every
  lock. Sanctioned raw sites (the factory internals) carry a G16
  pragma.
- **G16.1 guarded-field writes**: a registry-GUARDED field may be
  written only in ``__init__``, a ``*_locked``-suffixed method, a
  declared holder method, or lexically under ``with self.<lock>``
  (or a declared alias such as the Condition wrapping it).
- **G16.2 scrape isolation**: registry SCRAPE_ROOTS must be
  statically unreachable from any engine-lock acquisition, over the
  resolvable call graph (same-class ``self.`` calls, same-module
  calls, imported-module attribute calls, same-module tail-name
  fallback) — the repo-wide proof of "MetricsServer never takes an
  engine lock".
- **G16.3 blocking under engine lock**: no supervised dispatch,
  journal fsync/admit/ack, or host solve lexically inside ``with``
  on a registry ENGINE_LOCKS attribute (``BLOCKING_CALLS`` names the
  banned tails). The scheduler's ``_dispatch_lock`` is deliberately
  not an engine lock — dispatch under it is the drain design.

G17 is the raw-env ban: ``os.environ`` / ``os.getenv`` anywhere
outside ``config.py`` (the one home of validated parsers) is a
violation. Whole-
environment passthroughs to subprocesses (``env=dict(os.environ)``)
are sanctioned per-site with a G17 pragma — they forward, they do
not parse.

Separated from graftlint.py so tests can drive the per-rule halves
against AST fixtures without the full driver.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from pint_tpu_torch.analysis import graftlint as _gl
from pint_tpu_torch.analysis import lock_registry as _reg

Violation = _gl.Violation

# G16 scope: the dispatch layer (same file set as G6), the runtime
# supervision package, the obs plane, the serve CLI and the profiler
# scoreboard — everywhere locks guard cross-thread serving state.
_G16_EXTRA_DIRS = (f"{_gl.PKG}/runtime/", f"{_gl.PKG}/obs/",
                   f"{_gl.PKG}/scripts/")
_G16_EXTRA_FILES = {f"{_gl.PKG}/profiling.py"}

# mutation methods that count as writes to a guarded container
_MUTATORS = frozenset({
    "append", "appendleft", "add", "clear", "pop", "popleft",
    "popitem", "remove", "update", "setdefault", "extend", "insert",
    "discard",
})

# os.environ readers allowed raw (G17): the validated-parser home
G17_SANCTIONED = {
    f"{_gl.PKG}/config.py",
}


def g16_applies(relpath: str) -> bool:
    return (relpath in _gl.G6_DISPATCH_FILES
            or relpath in _G16_EXTRA_FILES
            or relpath.startswith(_gl.G6_DISPATCH_DIRS)
            or relpath.startswith(_G16_EXTRA_DIRS))


# --------------------------------------------------------------------
# G16.0 — raw threading primitive construction
# --------------------------------------------------------------------

def check_g16_raw_primitives(m) -> List[Violation]:
    if not g16_applies(m.relpath):
        return []
    out: List[Violation] = []
    for node in m.nodes:
        if not isinstance(node, ast.Call):
            continue
        tail = _gl._tail_name(node.func)
        if tail not in ("Lock", "RLock", "Condition"):
            continue
        root = _gl._root_name(node.func)
        if root == "threading" or (
                root == tail and _imports_name(m, tail, "threading")):
            out.append(Violation(
                "G16", m.relpath, node.lineno,
                f"raw threading.{tail}() in the dispatch/serve/"
                f"runtime/obs layer: construct through "
                f"runtime.locks.make_{'condition' if tail == 'Condition' else 'rlock' if tail == 'RLock' else 'lock'}() "
                f"so the $PINT_TPU_LOCK_TRACE build traces it "
                f"(register guarded fields in "
                f"analysis/lock_registry.py)",
                m.line_text(node.lineno)))
    return out


def _imports_name(m, name: str, frm: str) -> bool:
    for n in m.nodes:
        if isinstance(n, ast.ImportFrom) and n.module == frm and \
                any((a.asname or a.name) == name for a in n.names):
            return True
    return False


# --------------------------------------------------------------------
# G16.1 — guarded-field writes
# --------------------------------------------------------------------

def _self_field_write(node) -> str:
    """Field name when ``node`` writes ``self.<field>`` (plain /
    subscript / augmented assignment, or a mutating method call on
    the attribute), else None."""

    def attr_of(t):
        # self.<f>  or  self.<f>[...]
        if isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            return t.attr
        return None

    if isinstance(node, ast.Assign):
        for t in node.targets:
            f = attr_of(t)
            if f is not None:
                return f
    elif isinstance(node, ast.AugAssign):
        return attr_of(node.target)
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr in _MUTATORS:
        return attr_of(node.func.value)
    return None


def _with_lock_attrs(m, node) -> Set[str]:
    """Attribute names of every ``with self.<attr>`` the node sits
    lexically inside."""
    out: Set[str] = set()
    cur = m.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                e = item.context_expr
                if isinstance(e, ast.Attribute) and \
                        isinstance(e.value, ast.Name) and \
                        e.value.id == "self":
                    out.add(e.attr)
        cur = m.parents.get(cur)
    return out


def _enclosing_function_names(m, node) -> List[str]:
    """Every enclosing function name, innermost first — a write in a
    closure nested inside ``_expire_locked`` still counts as inside
    it."""
    names = []
    cur = m.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.append(cur.name)
        cur = m.parents.get(cur)
    return names


def check_g16_guarded_writes(m, hits: Dict[int, int]) -> List[Violation]:
    """``hits`` maps GUARDED entry index -> write count (the caller
    aggregates across modules for the stale check)."""
    entries = [(i, e) for i, e in enumerate(_reg.GUARDED)
               if e["file"] == m.relpath]
    if not entries:
        return []
    by_cls: Dict[str, Dict[str, Tuple[int, dict]]] = {}
    for i, e in entries:
        by_cls.setdefault(e["cls"], {})[e["field"]] = (i, e)
    out: List[Violation] = []
    for cls in m.classes:
        fields = by_cls.get(cls.name)
        if not fields:
            continue
        for node in ast.walk(cls):
            f = _self_field_write(node)
            if f is None or f not in fields:
                continue
            i, e = fields[f]
            hits[i] = hits.get(i, 0) + 1
            fn_names = _enclosing_function_names(m, node)
            if any(n == "__init__" or n.endswith("_locked") or
                   n in e.get("holders", ()) for n in fn_names):
                continue
            allowed = {e["lock"], *e.get("aliases", ())}
            if _with_lock_attrs(m, node) & allowed:
                continue
            out.append(Violation(
                "G16", m.relpath, node.lineno,
                f"write to guarded field `{cls.name}.{f}` outside "
                f"`with self.{e['lock']}` (registry: owned by "
                f"{e['lock']}; allowed holders: __init__, *_locked, "
                f"{tuple(e.get('holders', ())) or '()'}) — "
                f"unsynchronized against readers under the lock",
                m.line_text(getattr(node, 'lineno', 0))))
    return out


# --------------------------------------------------------------------
# G16.2 — scrape-path isolation (call-graph reachability)
# --------------------------------------------------------------------

def _module_alias_map(m, by_relpath: Dict[str, object]) -> Dict[str, str]:
    """Local name -> relpath for imports of scanned modules
    (``from pint_tpu_torch.obs import metrics as om`` => om ->
    obs/metrics).
    Also maps ``from mod import fname`` function imports as
    ``fname`` -> relpath (resolved at call time by name)."""
    out: Dict[str, str] = {}
    for n in m.nodes:
        if isinstance(n, ast.Import):
            for a in n.names:
                rel = a.name.replace(".", "/") + ".py"
                pkg = a.name.replace(".", "/") + "/__init__.py"
                tgt = rel if rel in by_relpath else \
                    pkg if pkg in by_relpath else None
                if tgt:
                    out[a.asname or a.name.split(".")[0]] = tgt
        elif isinstance(n, ast.ImportFrom) and n.module:
            base = n.module.replace(".", "/")
            for a in n.names:
                for cand in (f"{base}/{a.name}.py",
                             f"{base}/{a.name}/__init__.py"):
                    if cand in by_relpath:
                        out[a.asname or a.name] = cand
                        break
                else:
                    for cand in (base + ".py", base + "/__init__.py"):
                        if cand in by_relpath:
                            # from mod import fname: call `fname()`
                            # resolves into mod
                            out[a.asname or a.name] = cand
                            break
    return out


class CallGraph:
    """Name-resolved call graph over the scanned modules. Nodes are
    (relpath, ClassName.func | func). Resolution is deliberately
    conservative-but-useful: self-calls bind within the enclosing
    class, bare names within the module (or a `from`-import), module
    aliases across modules, and unresolvable receivers fall back to
    same-module tail-name matching."""

    def __init__(self, modules):
        self.by_relpath = {m.relpath: m for m in modules}
        # (relpath, qualname) -> ast node
        self.funcs: Dict[Tuple[str, str], object] = {}
        # (relpath, name) -> [qualnames]
        self.by_name: Dict[Tuple[str, str], List[str]] = {}
        for m in modules:
            for f in m.functions:
                cls = m.enclosing_class(f)
                qual = f"{cls.name}.{f.name}" if cls else f.name
                self.funcs[(m.relpath, qual)] = f
                self.by_name.setdefault(
                    (m.relpath, f.name), []).append(qual)
        self._aliases = {m.relpath: _module_alias_map(m, self.by_relpath)
                         for m in modules}
        self._edges: Dict[Tuple[str, str],
                          Set[Tuple[str, str]]] = {}

    def callees(self, key: Tuple[str, str]) -> Set[Tuple[str, str]]:
        if key in self._edges:
            return self._edges[key]
        relpath, qual = key
        m = self.by_relpath.get(relpath)
        node = self.funcs.get(key)
        out: Set[Tuple[str, str]] = set()
        if m is None or node is None:
            self._edges[key] = out
            return out
        cls_name = qual.split(".")[0] if "." in qual else None
        aliases = self._aliases.get(relpath, {})
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            if isinstance(fn, ast.Name):
                tgt = aliases.get(fn.id)
                if tgt and (tgt, fn.id) in self.by_name:
                    # from mod import fname
                    for q in self.by_name[(tgt, fn.id)]:
                        out.add((tgt, q))
                else:
                    for q in self.by_name.get(
                            (relpath, fn.id), []):
                        out.add((relpath, q))
            elif isinstance(fn, ast.Attribute):
                recv, name = fn.value, fn.attr
                if isinstance(recv, ast.Name) and recv.id == "self" \
                        and cls_name:
                    if (relpath, f"{cls_name}.{name}") in self.funcs:
                        out.add((relpath, f"{cls_name}.{name}"))
                        continue
                if isinstance(recv, ast.Name) and \
                        recv.id in aliases:
                    tgt = aliases[recv.id]
                    for q in self.by_name.get((tgt, name), []):
                        out.add((tgt, q))
                    continue
                # tail-name fallback, same module only
                for q in self.by_name.get((relpath, name), []):
                    out.add((relpath, q))
        self._edges[key] = out
        return out


def _engine_lock_acquirers(modules) -> Dict[Tuple[str, str], str]:
    """(relpath, qualname) -> lock attr, for every function that
    lexically acquires a registry engine lock (``with self.<attr>``
    or ``self.<attr>.acquire()``)."""
    by_file = {e["file"]: set(e["attrs"]) for e in _reg.ENGINE_LOCKS}
    out: Dict[Tuple[str, str], str] = {}
    for m in modules:
        attrs = by_file.get(m.relpath)
        if not attrs:
            continue
        for f in m.functions:
            cls = m.enclosing_class(f)
            qual = f"{cls.name}.{f.name}" if cls else f.name
            for n in ast.walk(f):
                hit = None
                if isinstance(n, ast.With):
                    for item in n.items:
                        e = item.context_expr
                        if isinstance(e, ast.Attribute) and \
                                isinstance(e.value, ast.Name) and \
                                e.value.id == "self" and \
                                e.attr in attrs:
                            hit = e.attr
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "acquire":
                    recv = n.func.value
                    if isinstance(recv, ast.Attribute) and \
                            isinstance(recv.value, ast.Name) and \
                            recv.value.id == "self" and \
                            recv.attr in attrs:
                        hit = recv.attr
                if hit:
                    out[(m.relpath, qual)] = hit
    return out


def check_g16_scrape_paths(modules) -> List[Violation]:
    graph = CallGraph(modules)
    acquirers = _engine_lock_acquirers(modules)
    out: List[Violation] = []
    for entry in _reg.SCRAPE_ROOTS:
        relpath, fname = entry["file"], entry["func"]
        m = graph.by_relpath.get(relpath)
        roots = [(relpath, q)
                 for q in graph.by_name.get((relpath, fname), [])]
        if m is None or not roots:
            out.append(Violation(
                "G16", relpath, 0,
                f"stale lock_registry SCRAPE_ROOTS entry: function "
                f"`{fname}` not found — delete or update the entry",
                scope="repo"))
            continue
        for root in roots:
            seen = set(roots)
            todo = list(roots)
            parent = {}
            while todo:
                cur = todo.pop()
                if cur in acquirers:
                    path = [cur]
                    while path[-1] in parent:
                        path.append(parent[path[-1]])
                    chain = " -> ".join(
                        f"{p[1]}" for p in reversed(path))
                    node = graph.funcs.get(root)
                    out.append(Violation(
                        "G16", relpath,
                        getattr(node, "lineno", 0),
                        f"scrape root `{fname}` reaches engine-lock "
                        f"acquisition `self.{acquirers[cur]}` via "
                        f"{chain} ({cur[0]}) — the scrape path must "
                        f"never block on an engine lock "
                        f"(lock_registry SCRAPE_ROOTS)"))
                    break
                for nxt in graph.callees(cur):
                    if nxt not in seen:
                        seen.add(nxt)
                        parent[nxt] = cur
                        todo.append(nxt)
            break  # one BFS covers all same-named roots
    return out


# --------------------------------------------------------------------
# G16.3 — blocking calls under an engine lock
# --------------------------------------------------------------------

def check_g16_blocking_under_lock(m) -> List[Violation]:
    attrs: Set[str] = set()
    for e in _reg.ENGINE_LOCKS:
        if e["file"] == m.relpath:
            attrs |= set(e["attrs"])
    if not attrs:
        return []
    out: List[Violation] = []
    for node in m.nodes:
        if not isinstance(node, ast.With):
            continue
        held = [item.context_expr for item in node.items
                if isinstance(item.context_expr, ast.Attribute)
                and isinstance(item.context_expr.value, ast.Name)
                and item.context_expr.value.id == "self"
                and item.context_expr.attr in attrs]
        if not held:
            continue
        for inner in ast.walk(node):
            if inner is node or not isinstance(inner, ast.Call):
                continue
            tail = _gl._tail_name(inner.func)
            if tail in _reg.BLOCKING_CALLS:
                out.append(Violation(
                    "G16", m.relpath, inner.lineno,
                    f"`{tail}(...)` inside `with self."
                    f"{held[0].attr}`: no supervised dispatch, "
                    f"journal fsync, or host solve may run under an "
                    f"engine lock — it stalls every submitter for "
                    f"the full RTT (lock_registry ENGINE_LOCKS / "
                    f"BLOCKING_CALLS)",
                    m.line_text(inner.lineno)))
    return out


# --------------------------------------------------------------------
# G16 driver + stale-entry check
# --------------------------------------------------------------------

def check_g16(m, hits: Dict[int, int]) -> List[Violation]:
    """Per-module G16: raw primitives + guarded writes + blocking
    under engine lock. ``hits`` is the run-wide GUARDED hit counter
    (pass the same dict for every module, then call
    ``g16_stale_entries``)."""
    out = check_g16_raw_primitives(m)
    out += check_g16_guarded_writes(m, hits)
    out += check_g16_blocking_under_lock(m)
    return out


def g16_stale_entries(hits: Dict[int, int]) -> List[Violation]:
    out: List[Violation] = []
    for i, e in enumerate(_reg.GUARDED):
        if not hits.get(i):
            out.append(Violation(
                "G16", e["file"], 0,
                f"stale lock_registry GUARDED entry ({e['cls']}."
                f"{e['field']}): no write to the field found — "
                f"delete or update the entry so the registry stays "
                f"honest", scope="repo"))
    return out


# --------------------------------------------------------------------
# G17 — validated-env enforcement
# --------------------------------------------------------------------

def check_g17(m) -> List[Violation]:
    if m.relpath in G17_SANCTIONED:
        return []
    bare_environ = _imports_name(m, "environ", "os")
    bare_getenv = _imports_name(m, "getenv", "os")
    out: List[Violation] = []
    for node in m.nodes:
        hit = None
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "os" and \
                node.attr in ("environ", "getenv"):
            hit = f"os.{node.attr}"
        elif isinstance(node, ast.Name) and (
                (bare_environ and node.id == "environ") or
                (bare_getenv and node.id == "getenv")):
            hit = node.id
        if hit:
            out.append(Violation(
                "G17", m.relpath, node.lineno,
                f"raw `{hit}` read outside {_gl.PKG}/config.py: env "
                f"knobs go through a validated config parser "
                f"(warn-and-ignore on bad values — the "
                f"dispatch_rtt_override_ms pattern); whole-env "
                f"subprocess passthroughs need a G17 pragma",
                m.line_text(node.lineno)))
    return out
