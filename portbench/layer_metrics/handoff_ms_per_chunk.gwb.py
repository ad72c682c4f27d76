"""Host milliseconds the dispatch supervisor adds to a sweep chunk: the
mean self time of the traced window's ``dispatch/pta.gwb/chunk*`` spans,
their time less their ``dispatch.run`` and ``dispatch.read`` children
(worker start and wake, breaker, deadline, bookkeeping), from the span
ring laid on the window's clock (``portbench.spans``).

Read under the traced window's CPU and CUDA profiler, which slows the
host; an untraced chunk's hand-off may read lower."""

from portbench import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    self_s = []
    for d in w.named("dispatch/pta.gwb/chunk"):
        run = w.child(d, "dispatch.run")
        if run is None:
            continue
        hr = w.child(d, "dispatch.read")
        self_s.append(d.dur - run.dur - (hr.dur if hr else 0.0))
    if not self_s:
        return None
    return 1e3 * sum(self_s) / len(self_s)
