"""Device milliseconds of the outer stage a point asked for: the
device's busy time from each sweep chunk's ``pta.gwb.outer`` span start
to its ``dispatch.read`` end (the spans laid on the window's clock by
``portbench.spans``), over the points asked in the traced window. The
sweep runs one chunk at a time and each chunk ends in its host read, so
each interval holds that chunk's outer stage alone."""

import bisect

from portbench import spans
from portbench.trace import union


def read(ctx):
    tr = ctx["trace"]
    if not tr.busy_s or not ctx["points"]:
        return None
    w = spans.window(ctx)
    if w is None:
        return None
    spells = []
    for d in w.named("dispatch/pta.gwb/chunk"):
        run, hr = w.child(d, "dispatch.run"), w.child(d, "dispatch.read")
        outer = w.child(run, "pta.gwb.outer") if run else None
        if outer is not None and hr is not None:
            spells.append((outer.t0, hr.t1))
    if not spells:
        return None
    iv = tr.busy_intervals
    ends = [e for _, e in iv]
    busy = 0.0
    for a, b in union(spells):
        k = bisect.bisect_right(ends, a)
        while k < len(iv) and iv[k][0] < b:
            busy += min(b, iv[k][1]) - max(a, iv[k][0])
            k += 1
    return 1e3 * busy / ctx["points"]
