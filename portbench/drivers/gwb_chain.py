"""A sampler's traffic: a Metropolis random walk over (log10 A, gamma)
that makes one ``GWBLikelihood.loglik`` call a step, the next point
depending on the value returned. Proposals and acceptance draws come from
the seed; a proposal outside the prior box is rejected without a call.
"""

from __future__ import annotations

import math
import time

import numpy as np


class Driver:
    def __init__(self, system, mix, seed):
        self.like = system.like
        self.mix = mix
        self.rng = np.random.default_rng([int(seed), 0xC4A1])
        self.box = (mix["log10_A_prior"], mix["gamma_prior"])
        self.scale = np.asarray(mix["proposal_sigma"], dtype=np.float64)
        self.x = np.asarray(mix["start"], dtype=np.float64)
        self.logl = None

    def _call(self, x):
        info = {}
        t0 = time.perf_counter()
        val = self.like.loglik(float(x[0]), float(x[1]), info=info)
        t1 = time.perf_counter()
        ok = info.get("used_pool") == "device" and math.isfinite(val)
        return {"points": 1, "t0": t0, "t1": t1, "ok": ok,
                "log10_A": x[:1].copy(), "gamma": x[1:].copy(),
                "values": np.asarray([val])}

    def _inside(self, x):
        return all(lo <= v <= hi for v, (lo, hi) in zip(x, self.box))

    def warm(self):
        for _ in range(int(self.mix["warm_calls"])):
            rec = self._call(self.x)
        self.logl = float(rec["values"][0])

    def call(self):
        while True:
            prop = self.x + self.scale * self.rng.standard_normal(2)
            u = self.rng.random()
            if self._inside(prop):
                break
        rec = self._call(prop)
        if rec["ok"] and math.log(max(u, 1e-300)) < \
                rec["values"][0] - self.logl:
            self.x, self.logl = prop, float(rec["values"][0])
        return rec

    traced_call = call
