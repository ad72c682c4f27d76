"""The photon likelihood's share of its roofline [%]: the least time the
card could take for the walker log-likelihoods of the traced window
(``portbench.photon_roofline``, from the port's ``walker_evals`` and
``lnlike_batches`` counters) over the device's busy time under the
``photon.lnlike`` spans (``portbench.photon_trace``)."""

from portbench import photon_roofline, photon_trace


def read(ctx):
    c = ctx["counters"]
    evals, batches = c.get("walker_evals", 0), c.get("lnlike_batches", 0)
    busy = photon_trace.lnlike_busy_s(ctx)
    if not busy or not evals or not batches:
        return None
    least = photon_roofline.lnlike_least_s(ctx["dims"]["photons"], evals,
                                           batches)
    return 100.0 * least / busy
