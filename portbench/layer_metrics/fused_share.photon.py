"""Share of the traced window's walker batches that the photon
likelihood's hand kernel evaluated: the port's ``PhotonMetrics`` counters
``fused_batches`` over ``lnlike_batches``. A program without the first
counter counts no fused batch and reads 0.0; one without batches reads
nothing."""


def read(ctx):
    c = ctx["counters"]
    batches = c.get("lnlike_batches", 0)
    if not batches:
        return None
    return c.get("fused_batches", 0) / batches
