"""MCMC fitting of timing models (a port of ``_run_sampler`` and
``MCMCFitter`` of pint_tpu/mcmc_fitter.py; reference:
src/pint/mcmc_fitter.py MCMCFitter).

The fitter is a thin consumer of ``pint_tpu_torch.sampling``: the
default ``mode="scan"`` runs the whole ensemble chain on the model's
device in chunks (``sampling.DeviceEnsembleSampler`` over a
``sampling.DevicePosterior``), and ``sample_noise=True`` adds the GP
noise hyperparameters (PLRedNoise log10_A/gamma, ECORR weights) to the
sampled dimensions. ``mode="host"`` keeps the host-loop
``EnsembleSampler`` over ``BayesianTiming.lnposterior_batch`` (two
vmapped calls per step).

The photon-template fitters of the reference (``PhotonMCMCFitter``,
``CompositeMCMCFitter``) need its pulse-profile templates, which the
port does not have yet (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from pint_tpu_torch.bayesian import BayesianTiming
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.sampler import EnsembleSampler
from pint_tpu_torch.sampling import DeviceEnsembleSampler, DevicePosterior

__all__ = ["MCMCFitter"]


def _run_sampler(fitter, p0, nsteps: int, progress: bool):
    """Run the fitter's sampler, host or device: the device sampler's
    positional random streams are anchored by a seed drawn from the
    fitter's numpy generator, so a seeded fitter stays reproducible in
    every mode."""
    if isinstance(fitter.sampler, EnsembleSampler):
        fitter.sampler.run_mcmc(p0, nsteps, progress=progress)
    else:
        seed = int(fitter.rng.integers(0, 2 ** 31 - 1))
        fitter.sampler.run_mcmc(p0, nsteps, seed=seed,
                                mode=fitter.mode, progress=progress)


class MCMCFitter(Fitter):
    """Posterior sampling over the model's free parameters (reference:
    MCMCFitter), on the model's device. fit_toas runs the ensemble and
    sets parameter values to posterior medians with std-dev
    uncertainties.

    ``mode``: "scan" (default — the whole chain on the device, one call
    per chain chunk), "host_loop" (the same chunk driven one step per
    call: the bit-equality oracle), or "host" (the host ensemble over
    ``BayesianTiming.lnposterior_batch``). ``sample_noise=True`` (device
    modes only) appends the model's GP noise hyperparameters to the
    sampled dimensions; their posterior medians land in
    ``self.noise_estimates`` rather than in the timing model."""

    def __init__(self, toas, model, nwalkers: int = 32,
                 rng: Optional[np.random.Generator] = None,
                 mode: str = "scan", sample_noise: bool = False):
        if mode == "host" and sample_noise:
            raise ValueError(
                "sample_noise requires a device mode (the host sampler "
                "consumes the fixed-noise posterior)")
        super().__init__(toas, model)
        self.mode = mode
        self.rng = rng or np.random.default_rng()
        self.noise_estimates: dict = {}
        if mode == "host":
            self.post = None
            self.bt = BayesianTiming(model, toas)
            ndim = self.bt.nparams
            self.param_labels = list(self.bt.param_labels)
            self.ntiming = ndim
        else:
            self.post = DevicePosterior(model, toas,
                                        sample_noise=sample_noise)
            self.bt = self.post.bt
            ndim = self.post.nparams
            self.param_labels = list(self.post.param_labels)
            self.ntiming = self.post.ntiming
        self.nwalkers = max(nwalkers, 2 * ndim + 2)
        if self.nwalkers % 2:
            self.nwalkers += 1
        if mode == "host":
            self.sampler = EnsembleSampler(
                self.nwalkers, ndim, self.bt.lnposterior_batch, rng=self.rng)
        else:
            self.sampler = DeviceEnsembleSampler(
                self.nwalkers, ndim, self.post.lnpost_batch,
                device=model.device)

    def _init_walkers(self, scatter):
        if self.post is not None:
            return self.post.init_walkers(self.nwalkers, rng=self.rng,
                                          scatter=scatter)
        th0 = self.bt.theta0
        scales = np.empty(self.bt.nparams)
        for k, name in enumerate(self.bt.param_labels):
            p = self.model.get_param(name)
            scales[k] = p.uncertainty if p.uncertainty else \
                max(abs(th0[k]) * 1e-10, 1e-14)
        return th0[None, :] + scatter * scales[None, :] \
            * self.rng.standard_normal((self.nwalkers, self.bt.nparams))

    def fit_toas(self, nsteps: int = 300, burn: Optional[int] = None,
                 scatter: float = 0.5, progress: bool = False):
        t0 = time.perf_counter()
        p0 = self._init_walkers(scatter)
        _run_sampler(self, p0, nsteps, progress)
        burn = nsteps // 3 if burn is None else burn
        flat = self.sampler.get_chain(discard=burn, flat=True)
        med = np.median(flat, axis=0)
        std = np.std(flat, axis=0)
        for k, name in enumerate(self.param_labels):
            if k >= self.ntiming:
                # sampled noise hyperparameters: reported, never
                # written into the timing model's parameter values
                self.noise_estimates[name] = {
                    "median": float(med[k]), "std": float(std[k])}
                continue
            p = self.model.get_param(name)
            p.set_dd((float(med[k]), 0.0))
            p.uncertainty = float(std[k])
            self.errors[name] = float(std[k])
        self.model.invalidate_cache(params_only=True)
        self.resids = Residuals(self.toas, self.model)
        chi2 = self.resids.chi2
        self.converged = self.sampler.acceptance_fraction > 0.05
        self._record_stats(chi2, nsteps, t0)
        return chi2
