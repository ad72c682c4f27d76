"""Device milliseconds a grid node spends in the delay chain, the
double-double phase and the jacfwd design: device-busy time under the
port's ``fit_step.phase_jacobian`` and ``fit_step.linear_columns``
ranges in the traced window, over its nodes."""

RANGES = ("fit_step.phase_jacobian", "fit_step.linear_columns")


def read(ctx):
    tr = ctx["trace"]
    busy = tr.range_busy_s(RANGES)
    if not busy or not ctx["points"]:
        return None
    return 1e3 * busy / ctx["points"]
