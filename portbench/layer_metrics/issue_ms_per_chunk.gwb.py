"""Host milliseconds a sweep chunk's payload takes to return: the mean
duration of the ``dispatch.run`` children of the traced window's
``dispatch/pta.gwb/chunk*`` spans (the upload of the chunk's points and
the issue of the outer stage; the run's ``pta.gwb.upload`` and
``pta.gwb.outer`` children split the two), from the span ring laid on
the window's clock (``portbench.spans``).

Read under the traced window's CPU and CUDA profiler, which slows the
host: the profiler's cost grows with the operations a chunk issues, so
the value reads above an untraced chunk's issue, and a change that cuts
operations reads a larger gain here than it makes untraced."""

from portbench import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    runs = [w.child(d, "dispatch.run")
            for d in w.named("dispatch/pta.gwb/chunk")]
    runs = [r for r in runs if r is not None]
    if not runs:
        return None
    return 1e3 * sum(r.dur for r in runs) / len(runs)
