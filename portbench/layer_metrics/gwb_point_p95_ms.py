"""95th percentile, over every call of the timed window (read in the
``--trace 1`` run, whose timed window runs untraced), of the milliseconds
from a call to its value back on the host. A failed call counts as the
window's whole length."""

import numpy as np


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    ms = [(c["t1"] - c["t0"]) * 1e3 if c["ok"] else ctx["elapsed_s"] * 1e3
          for c in calls]
    return float(np.percentile(ms, 95))
