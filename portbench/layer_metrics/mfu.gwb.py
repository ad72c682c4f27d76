"""The whole call's share of the card's float64 peak [%]: the outer
stage's flops for the points asked in the traced window over the
window's wall seconds at the float64 tensor-core rate."""

from portbench import roofline


def read(ctx):
    win = ctx["trace"].window_s
    if not win or not ctx["points"] or not ctx["trace"].busy_s:
        return None
    d = ctx["dims"]
    flops = ctx["points"] * roofline.gwb_outer_flops(d["npulsars"], d["m"])
    return 100.0 * flops / (win * roofline.PEAKS["f64_tensor_flops"])
