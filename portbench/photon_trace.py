"""The photon chain's device time in a traced window, by span.

The walkers' log-likelihoods run on the dispatch worker, a thread whose
ranges the profiler does not record, so the ``photon.lnlike`` and
``photon.htest`` spans come from the program's span ring, laid on the
window's clock by ``portbench.spans``: a kernel is a span's when the
host launched it inside the span, on whichever thread. The trace does
record every thread's launch calls; where it links no kernel to its
launch, the k-th launch (by its start) is paired with the k-th kernel
(by its start), which holds for kernels on one stream and is used only
where the two counts agree. K1 is the ``z2_kernel`` launch under
``photon.htest``.
"""

from __future__ import annotations

import bisect

from portbench import spans
from portbench.trace import LAUNCH_NAMES, union

K1 = "z2_kernel"
COPIES = ("Memcpy", "Memset")


def launched(tr):
    """[(host launch time, (start, end, name))] of the window's device
    operations whose launch is known, or [] (module docstring)."""
    known = [(t, op) for op, t in zip(tr.ops, tr.launched_at)
             if t is not None]
    if known:
        return known
    calls = sorted(a for a, _, n in tr.host if n in LAUNCH_NAMES)
    kernels = sorted(op for op in tr.ops if not op[2].startswith(COPIES))
    if len(calls) != len(kernels):
        return []
    return list(zip(calls, kernels))


def _issued_inside(tr, spells):
    """Device intervals of the operations the host launched inside the
    (sorted, disjoint) host intervals ``spells``."""
    starts = [a for a, _ in spells]
    out = []
    for t, op in launched(tr):
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= spells[k][1]:
            out.append(op)
    return out


def _under(ctx, name):
    """The window's device operations launched under the ring's spans
    called ``name``."""
    if not ctx["trace"].busy_s:
        return []
    w = spans.window(ctx)
    if w is None:
        return []
    spells = union([(s.t0, s.t1) for s in w.named(name) if s.name == name])
    return _issued_inside(ctx["trace"], spells) if spells else []


def lnlike_busy_s(ctx):
    """Device-busy seconds of the walkers' log-likelihoods, or None."""
    iv = union([(a, b) for a, b, _ in _under(ctx, "photon.lnlike")])
    return sum(b - a for a, b in iv) or None


def k1_launches(ctx):
    """(device seconds, count) of the K1 launches under the H-test's
    spans, or None."""
    ops = [(a, b) for a, b, n in _under(ctx, "photon.htest") if K1 in n]
    if not ops:
        return None
    return sum(b - a for a, b in ops), len(ops)
