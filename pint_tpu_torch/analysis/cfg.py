"""Function-scope control-flow graphs + a forward dataflow engine (a
copy of pint_tpu/analysis/cfg.py; pure ``ast``).

Reference: the classic worklist algorithm (Kildall 1973 / any dragon
book) specialized to Python ASTs — the substrate under
``pint_tpu_torch.analysis.graftflow``'s dtype-provenance analysis (G9).
graftlint's per-node rules are purely syntactic; the bug class
graftflow exists for — a silent float32 demotion reaching the dd
error-free-transform chain — is a *dataflow* property: a value
acquires a provenance at one statement and does damage at another,
possibly across branches and loops. Hence: basic
blocks, edges, and a fixpoint solver, instead of more ast.walk.

Scope and honesty:

- **Intraprocedural.** One CFG per ``ast.FunctionDef``. Calls are
  summarized by the client's transfer function (typically: join of
  argument values, plus client-known summaries for names like
  ``dd_to_dd32``). This is the same approximation class as
  graftlint's compute-reachability inference.
- **Structured control flow only.** if/while/for/try/with/return/
  break/continue/raise build real edges; match statements join all
  arms; anything exotic conservatively falls through. ``try`` bodies
  edge into their handlers from the block *entry* (an exception can
  fire mid-block), which over-approximates but never loses a path.
- **Environments are per-name lattice maps.** A name missing from an
  environment is "never bound on this path"; joining keeps the bound
  side (may-analysis: a fact that holds on SOME path must survive —
  exactly what a taint/provenance client wants).

The solver iterates to a fixpoint with a generous iteration bound
(lattices here are tiny and finite; the bound is a belt against a
client writing a non-monotone transfer, in which case we stop and
keep the conservative last state rather than loop forever).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, List

__all__ = ["Block", "CFG", "build_cfg", "run_dataflow", "join_envs"]


@dataclass
class Block:
    """A straight-line run of statements with edges to successors.

    ``stmts`` holds *simple* statements plus the header statements of
    compound ones (the ``If``/``While``/``For`` node itself is NOT
    re-executed — only its test/iter expressions matter to transfer
    functions, which receive the compound node tagged as a header).
    """

    bid: int
    stmts: List[ast.stmt] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)
    # statements that are compound headers (their bodies live in other
    # blocks); transfer functions should only evaluate their
    # test/iter expression side effects, not their bodies
    headers: List[ast.stmt] = field(default_factory=list)

    def add_succ(self, bid: int):
        if bid not in self.succs:
            self.succs.append(bid)


class CFG:
    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.blocks: List[Block] = []
        self.entry = self.new_block()
        self.exit = self.new_block()

    def new_block(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks.append(b)
        return b

    def preds(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {b.bid: [] for b in self.blocks}
        for b in self.blocks:
            for s in b.succs:
                out[s].append(b.bid)
        return out


class _Builder:
    """Recursive-descent CFG construction over a statement list."""

    def __init__(self, cfg: CFG):
        self.cfg = cfg
        # (loop_header_bid, loop_exit_bid) stack for break/continue
        self.loops: List[tuple] = []

    def build(self, stmts: List[ast.stmt], cur: Block) -> Block:
        """Append ``stmts`` starting in ``cur``; return the block
        control falls out of (may be a fresh empty block; a block
        with no successors and no fall-through is dead)."""
        for st in stmts:
            cur = self._stmt(st, cur)
        return cur

    def _stmt(self, st: ast.stmt, cur: Block) -> Block:
        c = self.cfg
        if isinstance(st, ast.If):
            cur.stmts.append(st)
            cur.headers.append(st)
            then_b = c.new_block()
            cur.add_succ(then_b.bid)
            then_end = self.build(st.body, then_b)
            join = c.new_block()
            then_end.add_succ(join.bid)
            if st.orelse:
                else_b = c.new_block()
                cur.add_succ(else_b.bid)
                else_end = self.build(st.orelse, else_b)
                else_end.add_succ(join.bid)
            else:
                cur.add_succ(join.bid)
            return join
        if isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            header = c.new_block()
            cur.add_succ(header.bid)
            header.stmts.append(st)
            header.headers.append(st)
            body_b = c.new_block()
            exit_b = c.new_block()
            header.add_succ(body_b.bid)
            header.add_succ(exit_b.bid)  # zero-trip / loop done
            self.loops.append((header.bid, exit_b.bid))
            body_end = self.build(st.body, body_b)
            body_end.add_succ(header.bid)  # back edge
            self.loops.pop()
            if st.orelse:
                # else runs on normal loop exit; approximate by
                # running it on the exit path
                else_end = self.build(st.orelse, exit_b)
                return else_end
            return exit_b
        if isinstance(st, ast.Try):
            cur.stmts.append(st)
            cur.headers.append(st)
            body_b = c.new_block()
            cur.add_succ(body_b.bid)
            join = c.new_block()
            body_end = self.build(st.body, body_b)
            body_end.add_succ(join.bid)
            for h in st.handlers:
                h_b = c.new_block()
                # exceptions can fire anywhere in the body: edge from
                # the body's ENTRY (pre-body env) — conservative
                cur.add_succ(h_b.bid)
                body_end.add_succ(h_b.bid)
                h_end = self.build(h.body, h_b)
                h_end.add_succ(join.bid)
            if st.orelse:
                join = self.build(st.orelse, join)
            if st.finalbody:
                join = self.build(st.finalbody, join)
            return join
        if isinstance(st, (ast.With, ast.AsyncWith)):
            cur.stmts.append(st)
            cur.headers.append(st)
            return self.build(st.body, cur)
        if isinstance(st, ast.Return):
            cur.stmts.append(st)
            cur.add_succ(self.cfg.exit.bid)
            return c.new_block()  # dead continuation
        if isinstance(st, ast.Raise):
            cur.stmts.append(st)
            cur.add_succ(self.cfg.exit.bid)
            return c.new_block()
        if isinstance(st, ast.Break):
            if self.loops:
                cur.add_succ(self.loops[-1][1])
            return c.new_block()
        if isinstance(st, ast.Continue):
            if self.loops:
                cur.add_succ(self.loops[-1][0])
            return c.new_block()
        if isinstance(st, ast.Match):
            cur.stmts.append(st)
            cur.headers.append(st)
            join = c.new_block()
            fell = False
            for case in st.cases:
                case_b = c.new_block()
                cur.add_succ(case_b.bid)
                end = self.build(case.body, case_b)
                end.add_succ(join.bid)
                if case.pattern.__class__.__name__ == "MatchAs" and \
                        getattr(case.pattern, "pattern", None) is None:
                    fell = True  # wildcard case
            if not fell:
                cur.add_succ(join.bid)  # no-match fall-through
            return join
        # simple statement (incl. nested FunctionDef/ClassDef, which
        # clients treat as a binding of the name)
        cur.stmts.append(st)
        return cur


def build_cfg(fn: ast.FunctionDef) -> CFG:
    cfg = CFG(fn)
    end = _Builder(cfg).build(fn.body, cfg.entry)
    end.add_succ(cfg.exit.bid)
    return cfg


def join_envs(a: Dict[str, object], b: Dict[str, object],
              join_val: Callable[[object, object], object]
              ) -> Dict[str, object]:
    """May-join of two environments: union of names; values joined
    where both sides bind, kept where only one does."""
    out = dict(a)
    for k, v in b.items():
        out[k] = join_val(out[k], v) if k in out else v
    return out


def run_dataflow(cfg: CFG, init_env: Dict[str, object],
                 transfer: Callable[[ast.stmt, Dict[str, object],
                                     bool], None],
                 join_val: Callable[[object, object], object],
                 max_iter: int = 64,
                 ) -> Dict[int, Dict[str, object]]:
    """Forward worklist solve. ``transfer(stmt, env, is_header)``
    mutates ``env`` in place; it must be monotone over the client
    lattice. Returns the IN-environment per block id (the exit
    block's IN env is the function's final state). A second,
    post-fixpoint pass is the client's job (re-run transfer with
    recording enabled over each block using these IN envs)."""
    preds = cfg.preds()
    in_envs: Dict[int, Dict[str, object]] = {cfg.entry.bid: dict(init_env)}
    out_envs: Dict[int, Dict[str, object]] = {}
    work = [cfg.entry.bid]
    iters = 0
    while work and iters < max_iter * max(1, len(cfg.blocks)):
        iters += 1
        bid = work.pop(0)
        block = cfg.blocks[bid]
        env = dict(in_envs.get(bid, {}))
        for st in block.stmts:
            transfer(st, env, st in block.headers)
        if out_envs.get(bid) == env and bid in out_envs:
            continue
        out_envs[bid] = env
        for s in block.succs:
            merged = env if s not in in_envs else \
                join_envs(in_envs[s], env, join_val)
            if merged != in_envs.get(s):
                in_envs[s] = merged
                if s not in work:
                    work.append(s)
    # make sure every reachable block has an IN env for replay passes
    for b in cfg.blocks:
        in_envs.setdefault(b.bid, {})
    return in_envs
