"""Kernel launches in the traced window, the dispatch worker's with the
caller's (the trace records every thread's launch calls), over the
walker log-likelihoods the port's ``PhotonMetrics`` counted there."""


def read(ctx):
    tr = ctx["trace"]
    evals = ctx["counters"].get("walker_evals", 0)
    if not tr.launches or not evals:
        return None
    return tr.launches / evals
