"""1 - (union of the device's busy intervals) / the traced window's wall
seconds."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.window_s or not tr.busy_s:
        return None
    return 1.0 - tr.busy_s / tr.window_s
