"""An ``event_optimize`` chain: an ensemble of walkers over the photon
fitter's likelihood (the stretch move on the device, a
``DeviceEnsembleSampler`` built as ``PhotonMCMCFitter`` builds its own)
run one chain chunk a call, each call continuing from the last one's
walkers and log-likelihoods, then the closing H-test at the chunk's
highest-log L walker. The walkers start about the par file's values,
scattered by ``scatter_sigma`` times the reference's errors; the chunks'
random streams are anchored by seeds drawn from the run's seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Driver:
    def __init__(self, system, mix, seed):
        from pint_tpu_torch.sampling import DeviceEnsembleSampler

        self.system = system
        self.mix = mix
        fitter = system.fitter
        self.nw, self.nd = int(mix["nwalkers"]), fitter.nparams
        self.sampler = DeviceEnsembleSampler(
            self.nw, self.nd, fitter.lnpost_batch, device=fitter.device)
        self.steps = int(mix["steps"])
        self.rng = np.random.default_rng([int(seed), 0xE0E0])
        self.pos = fitter.theta0[None, :] + float(mix["scatter_sigma"]) \
            * np.asarray(system.sigma)[None, :] \
            * self.rng.standard_normal((self.nw, self.nd))
        self.lp = None

    def _call(self):
        seed = int(self.rng.integers(0, 2 ** 31 - 1))
        before = self.sampler.naccepted
        t0 = time.perf_counter()
        pos = self.sampler.run_mcmc(self.pos, self.steps, seed=seed,
                                    mode=self.mix["mode"], lp0=self.lp)
        lnp, chain = self.sampler.lnprob, self.sampler.chain
        best = chain[np.unravel_index(np.argmax(lnp), lnp.shape)]
        h = self.system.htest(best)
        t1 = time.perf_counter()
        self.pos, self.lp = pos, lnp[-1].copy()
        return {"points": self.steps * self.nw, "t0": t0, "t1": t1,
                "ok": bool(np.all(np.isfinite(lnp)) and np.isfinite(h)),
                "thetas": chain.reshape(-1, self.nd),
                "values": lnp.reshape(-1), "best": best.copy(), "h": h,
                "accepted": (self.sampler.naccepted - before)
                / (self.steps * self.nw)}

    def warm(self):
        """The starting walkers' log-likelihoods, a half-ensemble at a
        time as the chain evaluates them, then ``warm_calls`` calls."""
        f = self.system.fitter
        x = torch.as_tensor(self.pos, device=f.device)
        half = self.nw // 2
        self.lp = torch.cat([f.lnpost_batch(x[:half]),
                             f.lnpost_batch(x[half:])]).cpu().numpy()
        for _ in range(int(self.mix["warm_calls"])):
            self._call()

    def call(self):
        return self._call()

    traced_call = call
