"""Device milliseconds a walker's log-likelihood over every photon
costs: device-busy time under the port's ``photon.lnlike`` spans in the
traced window (``portbench.photon_trace``), over the walker
log-likelihoods the port's ``PhotonMetrics`` counted there
(``walker_evals``)."""

from portbench import photon_trace


def read(ctx):
    evals = ctx["counters"].get("walker_evals", 0)
    busy = photon_trace.lnlike_busy_s(ctx)
    if not busy or not evals:
        return None
    return 1e3 * busy / evals
