"""Device milliseconds a grid node spends in the GLS core: device-busy
time under the port's ``fit_step.gram``, ``fit_step.ecorr_segments`` and
``fit_step.cholesky_solves`` ranges in the traced window, over its
nodes."""

RANGES = ("fit_step.gram", "fit_step.ecorr_segments",
          "fit_step.cholesky_solves")


def read(ctx):
    tr = ctx["trace"]
    busy = tr.range_busy_s(RANGES)
    if not busy or not ctx["points"]:
        return None
    return 1e3 * busy / ctx["points"]
