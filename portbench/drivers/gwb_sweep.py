"""A detection sweep: repeated ``GWBLikelihood.loglik_grid`` calls over
a (log10 A, gamma) grid, each repetition moved by a sub-cell offset drawn
from the seed, so that no two grids are alike. One call is one grid; the
sweep driver batches its points into chunks of ``config.gwb_chunk()``.
"""

from __future__ import annotations

import time

import numpy as np


class Driver:
    def __init__(self, system, mix, seed):
        self.like = system.like
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 0x6E1D])
        na, ng = mix["grid"]
        self.axes = (np.linspace(*mix["log10_A"], na),
                     np.linspace(*mix["gamma"], ng))
        self.steps = tuple(np.ptp(ax) / (len(ax) - 1) for ax in self.axes)

    def _grid(self, npoints=None):
        off = self.rng.uniform(-0.5, 0.5, size=2)
        la, ga = np.meshgrid(self.axes[0] + off[0] * self.steps[0],
                             self.axes[1] + off[1] * self.steps[1],
                             indexing="ij")
        la, ga = la.ravel(), ga.ravel()
        if npoints is not None:
            la, ga = la[:npoints], ga[:npoints]
        return la, ga

    def _call(self, la, ga):
        info = {}
        t0 = time.perf_counter()
        vals = self.like.loglik_grid(la, ga, info=info)
        t1 = time.perf_counter()
        ok = info.get("used_pool") == "device" and bool(
            np.all(np.isfinite(vals)))
        return {"points": len(la), "t0": t0, "t1": t1, "ok": ok,
                "log10_A": la, "gamma": ga, "values": np.asarray(vals)}

    def warm(self):
        self._call(*self._grid(self.mix["warm_points"]))

    def call(self):
        return self._call(*self._grid())

    def traced_call(self):
        return self._call(*self._grid(self.mix["trace_points"]))
