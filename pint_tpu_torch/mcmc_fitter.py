"""MCMC fitting of timing models and photon-template likelihoods (a port
of pint_tpu/mcmc_fitter.py; reference: src/pint/mcmc_fitter.py
MCMCFitter, MCMCFitterAnalyticTemplate, CompositeMCMCFitter, and
event_optimize's likelihood).

The fitter is a thin consumer of ``pint_tpu_torch.sampling``: the
default ``mode="scan"`` runs the whole ensemble chain on the model's
device in chunks (``sampling.DeviceEnsembleSampler`` over a
``sampling.DevicePosterior``), and ``sample_noise=True`` adds the GP
noise hyperparameters (PLRedNoise log10_A/gamma, ECORR weights) to the
sampled dimensions. ``mode="host"`` keeps the host-loop
``EnsembleSampler`` over ``BayesianTiming.lnposterior_batch`` (two
vmapped calls per step).

``PhotonMCMCFitter`` samples the timing parameters against the unbinned
photon-template likelihood sum_i log(w_i f(phi_i(theta)) + 1 - w_i),
the template fixed (event_optimize's use), with the same three modes;
the walker batch is one ``torch.func.vmap`` of the dd phase chain and
the template pdf, in chunks of ``config.photon_walker_chunk`` walkers.
``CompositeMCMCFitter`` adds radio TOAs' ``BayesianTiming`` posterior to
it, on the host sampler.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import config
from pint_tpu_torch.bayesian import BayesianTiming, build_batched_phase_eval
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.sampler import EnsembleSampler
from pint_tpu_torch.sampling import DeviceEnsembleSampler, DevicePosterior

__all__ = ["MCMCFitter", "PhotonMCMCFitter", "CompositeMCMCFitter"]


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


def _lazy_host_posterior(model, toas, sample_noise: bool):
    """The chain's failover posterior on the CPU, built from a CPU copy of
    ``model`` at its first call (a chain that never fails over never
    builds it); None on a CPU model, whose sampler reuses its own."""
    if model.device.type == "cpu":
        return None
    built: list = []

    def lnpost_batch(x):
        if not built:
            from pint_tpu_torch.fitter import cpu_copy

            built.append(DevicePosterior(cpu_copy(model), toas,
                                         sample_noise=sample_noise))
        return built[0].lnpost_batch(x)

    return lnpost_batch


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
                device=model.device,
                host_lnpost_batch=_lazy_host_posterior(
                    model, toas, sample_noise))

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


class PhotonMCMCFitter:
    """Sample timing parameters against an unbinned photon-template
    likelihood (reference: MCMCFitterAnalyticTemplate / event_optimize)
    on the model's device. The phase model is re-evaluated per sample
    through the dd low word (``bayesian.build_batched_phase_eval``); a
    batch of walkers is one vmapped pass of the chain and the template's
    pdf, in chunks of ``config.photon_walker_chunk(N)`` walkers (the
    result does not depend on the chunk).

    ``mode``: "scan" (default) or "host_loop" run
    ``sampling.DeviceEnsembleSampler`` over the vmapped likelihood;
    "host" runs the host ``EnsembleSampler`` over ``_lp_batch``."""

    def __init__(self, toas, model, template, weights=None,
                 nwalkers: int = 32,
                 rng: Optional[np.random.Generator] = None,
                 mode: str = "scan"):
        self.toas = toas
        self.model = model
        self.template = template
        self.mode = mode
        self.device = dev = model.device
        self.param_labels = list(model.free_params)
        self.nparams = len(self.param_labels)
        self.nwalkers = max(nwalkers, 2 * self.nparams + 2)
        if self.nwalkers % 2:
            self.nwalkers += 1
        self.rng = rng or np.random.default_rng()

        self.theta0, self._tl0, frac_fn = build_batched_phase_eval(
            model, toas)
        w = (torch.ones(toas.ntoas, dtype=torch.float64, device=dev)
             if weights is None else
             torch.as_tensor(weights, dtype=torch.float64, device=dev))
        wc = 1.0 - w
        pdf = template._pdf_fn()
        ttheta = torch.as_tensor(template.theta, dtype=torch.float64,
                                 device=dev)

        def lnlike_core(tl_eff):
            phases = torch.remainder(frac_fn(tl_eff), 1.0)
            dens = pdf(ttheta, phases)
            return torch.sum(torch.log(w * dens + wc))

        core = torch.func.vmap(lnlike_core)
        chunk = config.photon_walker_chunk(toas.ntoas)

        def core_batch(tl_eff):
            if tl_eff.shape[0] <= chunk:
                return core(tl_eff)
            return torch.cat([core(tl_eff[a:a + chunk])
                              for a in range(0, tl_eff.shape[0], chunk)])

        self._core_batch = core_batch
        if mode == "host":
            self.sampler = EnsembleSampler(
                self.nwalkers, self.nparams, self._lp_batch, rng=self.rng)
        else:
            th0_t = torch.as_tensor(self.theta0, device=dev)
            tl0_t = torch.as_tensor(self._tl0, device=dev)

            def lnpost_batch(thetas):
                return core_batch(tl0_t + (thetas - th0_t))

            self.lnpost_batch = lnpost_batch
            self.sampler = DeviceEnsembleSampler(
                self.nwalkers, self.nparams, lnpost_batch, device=dev)

    def _photon_lnlike_batch(self, thetas: np.ndarray) -> np.ndarray:
        """(S,) photon log-likelihoods of an (S, nparams) batch, tl_eff
        formed on the host in float64."""
        tl_eff = self._tl0[None, :] + (
            np.asarray(thetas, dtype=np.float64) - self.theta0[None, :])
        return self._core_batch(
            torch.as_tensor(tl_eff, device=self.device)).cpu().numpy()

    def _lp_batch(self, thetas: np.ndarray) -> np.ndarray:
        """Log posterior per walker; subclasses compose extra terms."""
        return self._photon_lnlike_batch(thetas)

    def fit_toas(self, nsteps: int = 300, burn: Optional[int] = None,
                 scatter: float = 1e-9, progress: bool = False):
        """Run the chain from walkers scattered by ``scatter`` relative
        about the model's values; set each parameter to its posterior
        median with the standard deviation as uncertainty. Returns the
        chain's largest log-likelihood."""
        scales = np.maximum(np.abs(self.theta0) * scatter, 1e-16)
        p0 = self.theta0[None, :] + scales[None, :] \
            * self.rng.standard_normal((self.nwalkers, self.nparams))
        _run_sampler(self, p0, nsteps, progress)
        burn = nsteps // 3 if burn is None else burn
        flat = self.sampler.get_chain(discard=burn, flat=True)
        med = np.median(flat, axis=0)
        std = np.std(flat, axis=0)
        self.errors = {}
        for k, name in enumerate(self.param_labels):
            p = self.model.get_param(name)
            p.set_dd((float(med[k]), 0.0))
            p.uncertainty = float(std[k])
            self.errors[name] = float(std[k])
        self.model.invalidate_cache(params_only=True)
        return float(np.max(self.sampler.lnprob))


class CompositeMCMCFitter(PhotonMCMCFitter):
    """Joint radio-TOA + photon-event posterior over one timing model
    (reference: mcmc_fitter.CompositeMCMCFitter): lnpost(theta) =
    lnpost_TOA(theta; radio toas, priors) + lnL_photon(theta; event
    phases, template), each a batched call on the model's device. The
    host sampler only (mode "host", as in the reference): the two terms
    are combined on the host, the photon term added where the TOA term
    is finite."""

    def __init__(self, toas_radio, toas_events, model, template,
                 weights=None, nwalkers: int = 32,
                 rng: Optional[np.random.Generator] = None):
        super().__init__(toas_events, model, template,
                         weights=weights, nwalkers=nwalkers, rng=rng,
                         mode="host")
        self.toas = toas_radio
        self.toas_events = toas_events
        self.bt = BayesianTiming(model, toas_radio)

    def _lp_batch(self, thetas: np.ndarray) -> np.ndarray:
        thetas = np.asarray(thetas, dtype=np.float64)
        lp = np.asarray(self.bt.lnposterior_batch(thetas),
                        dtype=np.float64)
        finite = np.isfinite(lp)
        if finite.any():
            ph = self._photon_lnlike_batch(thetas)
            lp = np.where(finite, lp + ph, lp)
        return lp
