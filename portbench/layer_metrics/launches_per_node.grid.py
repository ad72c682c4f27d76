"""Kernel launches the host issued in the traced window, over the grid
nodes it refit."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.launches or not ctx["points"]:
        return None
    return tr.launches / ctx["points"]
