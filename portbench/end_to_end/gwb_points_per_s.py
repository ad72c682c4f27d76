"""GWB log-likelihood points that the caller asked for and got back from
the device in the window, over the window's seconds (from the first call
to the return of the last; padding does not count)."""


def read(ctx):
    done = sum(c["points"] for c in ctx["calls"] if c["ok"])
    return done / ctx["elapsed_s"] if done else None
