"""Share of the traced window in which the device is idle and no sweep
chunk's dispatch is open: 1 - (union of the device's busy intervals and
the ``dispatch/pta.gwb/chunk*`` spans, laid on the window's clock by
``portbench.spans``) / the window's wall seconds. The caller's time
between chunks; at most ``idle_share.gwb``."""

from portbench import spans
from portbench.trace import union


def read(ctx):
    tr = ctx["trace"]
    if not tr.window_s or not tr.busy_s:
        return None
    w = spans.window(ctx)
    if w is None:
        return None
    chunks = [(d.t0, d.t1) for d in w.named("dispatch/pta.gwb/chunk")]
    if not chunks:
        return None
    covered = union(list(tr.busy_intervals) + chunks)
    return 1.0 - sum(b - a for a, b in covered) / tr.window_s
