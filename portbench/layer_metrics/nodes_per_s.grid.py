"""Refit nodes of the chi-squared grid that came back in the timed
window, over the window's seconds (from the first call to the return of
the last), read in the ``--trace 1`` run, whose timed window runs
untraced. The host's eager dispatch sets this rate, and it follows the
speed of the host's shared cores (PERF.md, section 2)."""


def read(ctx):
    done = sum(c["points"] for c in ctx["calls"] if c["ok"])
    return done / ctx["elapsed_s"] if done else None
