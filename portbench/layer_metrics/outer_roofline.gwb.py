"""The outer stage's share of its roofline [%]: the least time the card
could take for the points asked in the traced window (portbench.roofline)
over the device's busy time there."""

from portbench import roofline


def read(ctx):
    busy = ctx["trace"].busy_s
    if not busy or not ctx["points"]:
        return None
    d = ctx["dims"]
    least = roofline.gwb_outer_least_s(d["npulsars"], d["m"], ctx["points"])
    return 100.0 * least / busy
