"""A chi-squared grid: repeated ``gridutils.grid_chisq`` calls over an
outer-product grid of two parameters held fixed while every other free
parameter is refit, each repetition moved by a sub-cell offset drawn
from the seed, so that no two grids are alike. One call is one grid; the
port refits its nodes ``config.grid_chunk`` at a time.
"""

from __future__ import annotations

import time

import numpy as np


class Driver:
    def __init__(self, system, mix, seed):
        self.system = system
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 0x6A1D])
        self.params = tuple(mix["params"])
        self.centre = np.asarray(mix["centre"], np.float64)
        self.sigma = np.asarray(mix["sigma"], np.float64)

    def _grid(self, shape):
        span = float(self.mix["sigma_span"])
        off = self.rng.uniform(-0.5, 0.5, size=len(shape))
        axes = []
        for i, n in enumerate(shape):
            base = np.linspace(-span, span, n)
            step = 2.0 * span / (n - 1)
            axes.append(self.centre[i] + (base + off[i] * step)
                        * self.sigma[i])
        return axes

    def _call(self, axes):
        from pint_tpu_torch.gridutils import grid_chisq

        s = self.system
        t0 = time.perf_counter()
        chi2 = grid_chisq(s.model, s.toas, self.params, axes,
                          maxiter=s.maxiter)
        t1 = time.perf_counter()
        mesh = np.meshgrid(*axes, indexing="ij")
        nodes = np.stack([m.ravel() for m in mesh], axis=1)
        vals = np.asarray(chi2, np.float64).ravel()
        return {"points": len(vals), "t0": t0, "t1": t1,
                "ok": bool(np.all(np.isfinite(vals))), "nodes": nodes,
                "values": vals}

    def warm(self):
        self._call(self._grid(self.mix["warm_grid"]))

    def call(self):
        return self._call(self._grid(self.mix["grid"]))

    traced_call = call
