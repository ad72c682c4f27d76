"""Host milliseconds a grid spends rebuilding its refit step (the
model's copy, the freezing and ``build_fit_step``): the port's
``grid.build`` spans in the traced window, over its ``grid.chisq``
spans (one a grid), from the span ring laid on the window's clock
(``portbench.spans``). Read under the traced window's CPU and CUDA
profiler, which slows the host."""

from portbench import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    builds, grids = w.named("grid.build"), w.named("grid.chisq")
    if not builds or not grids:
        return None
    return 1e3 * sum(s.dur for s in builds) / len(grids)
