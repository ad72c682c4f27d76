"""Device milliseconds a refit node of the chi-squared grid costs: the
union of the device's busy intervals over every call of the timed
window, each call under a device-only profiler session, over the nodes
that came back. None where no device activity was recorded (no card)."""


def read(ctx):
    busy = ctx.get("window_busy_s")
    done = sum(c["points"] for c in ctx["calls"] if c["ok"])
    if not busy or not done:
        return None
    return 1e3 * busy / done
