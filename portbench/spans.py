"""The program's span ring laid on a traced window's clock.

While a ``torch.profiler`` session is open the port records its spans
(``pint_tpu_torch.obs.span``) into a ring, stamped in real-time
microseconds, and the spans opened on the profiled thread also appear
among the trace's host ranges, in seconds from the trace's start. The
spans that appear in both (the main thread's ``dispatch/<key>``,
``pta.gwb_sweep``, ``pta.gwb.loglik_grid`` and ``grid.*`` spans) give
the offset between the two axes: for each such range, the ring span of
its name whose offset lies nearest the offset that most pairs share,
within ``TOL_S``; the offset is their median. Ring spans of other
threads (the dispatch worker's ``dispatch.run``, ``dispatch.read``,
``pta.gwb.upload``, ``pta.gwb.outer``) are then placed on the trace's
axis too.

``window(ctx)`` is None where the ring holds no span that the trace
has: a program that records none, or a run with no profiled window.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

# how far apart two stamps of one span may lie on the two axes
TOL_S = 200e-6
MATCHED = ("dispatch/", "grid.", "pta.gwb_sweep", "pta.gwb.loglik_grid")


class Span:
    __slots__ = ("name", "t0", "t1", "id", "parent")

    def __init__(self, rec: dict, offset_s: float):
        self.name = rec["name"]
        self.t0 = rec["ts"] * 1e-6 - offset_s
        self.t1 = self.t0 + rec["dur"] * 1e-6
        self.id = rec["args"].get("span")
        self.parent = rec["args"].get("parent")

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Window:
    """The ring's completed spans on the trace's axis (seconds), those
    that lie inside the traced window in ``spans``; ``offsets`` are the
    matched pairs' offsets, whose spread ``spread_s`` measures the
    alignment."""

    def __init__(self, spans: List[Span], inside: List[Span],
                 offsets: List[float]):
        self.spans = inside
        self.offsets = offsets
        self.offset_s = statistics.median(offsets)
        self._kids: Dict[int, List[Span]] = {}
        for s in spans:
            if s.parent is not None:
                self._kids.setdefault(s.parent, []).append(s)

    @property
    def spread_s(self) -> float:
        """Interquartile range of the matched offsets (0 for fewer than
        two)."""
        if len(self.offsets) < 2:
            return 0.0
        q = statistics.quantiles(self.offsets, n=4)
        return q[2] - q[0]

    def named(self, prefix: str) -> List[Span]:
        """The window's spans whose name starts with ``prefix``."""
        return [s for s in self.spans if s.name.startswith(prefix)]

    def child(self, span: Span, name: str) -> Optional[Span]:
        """The first child of ``span`` called ``name``."""
        for k in self._kids.get(span.id, ()):
            if k.name == name:
                return k
        return None


def ring() -> list:
    """The completed spans in the program's ring (empty where the
    program cannot be imported)."""
    try:
        from pint_tpu_torch import obs
    except ImportError:
        return []
    return [r for r in obs.get_tracer().records() if r["ph"] == "X"]


def _matched(name: str) -> bool:
    return name.startswith(MATCHED)


def offsets(host, records) -> List[float]:
    """The offsets [s] (ring start less trace start) of the trace's
    matched host ranges, each paired with the ring span of its name
    nearest the offset that most pairs share."""
    starts: Dict[str, List[float]] = {}
    for a, _, n in host:
        if _matched(n):
            starts.setdefault(n, []).append(a)
    stamps: Dict[str, List[float]] = {}
    for r in records:
        if r["name"] in starts:
            stamps.setdefault(r["name"], []).append(r["ts"] * 1e-6)
    cands = sorted(t - a for n, ts in stamps.items() for a in starts[n]
                   for t in ts)
    if not cands:
        return []
    # the offset with the most pairs within TOL_S of it
    best, lo = (0, 0.0), 0
    for hi, c in enumerate(cands):
        while cands[lo] < c - 2 * TOL_S:
            lo += 1
        if hi - lo + 1 > best[0]:
            best = (hi - lo + 1, 0.5 * (cands[lo] + c))
    centre = best[1]
    out = []
    for n, ts in stamps.items():
        for a in starts[n]:
            d = min(ts, key=lambda t: abs(t - a - centre)) - a
            if abs(d - centre) <= TOL_S:
                out.append(d)
    return out


def window(ctx) -> Optional[Window]:
    """The ring laid on ``ctx["trace"]``'s axis, or None (module
    docstring)."""
    tr = ctx.get("trace")
    if tr is None or not tr.host:
        return None
    records = ring()
    offs = offsets(tr.host, records)
    if not offs:
        return None
    off = statistics.median(offs)
    spans = [Span(r, off) for r in records]
    lo = min(a for a, _, _ in tr.host) - TOL_S
    hi = max(b for _, b, _ in tr.host) + TOL_S
    inside = [s for s in spans if s.t0 >= lo and s.t1 <= hi]
    return Window(spans, inside, offs)
