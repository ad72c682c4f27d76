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
on a CUDA model whose free parameters are all Spindown's spin terms and
whose template is all ``LCGaussian``s (``fused_inputs``), a walker batch
is one call of the hand-written kernel (``ops/photon_lnlike.py``), in
chunks of ``photon_lnlike.MAX_WALKERS`` walkers; otherwise it is one
``torch.func.vmap`` of the dd phase chain and the template pdf, in
chunks of ``config.photon_walker_chunk`` walkers. Each chunk is a
``photon.lnlike`` span (``walkers``, ``photons``, ``chunk``) counted in
``PhotonMetrics``. ``CompositeMCMCFitter`` adds
radio TOAs' ``BayesianTiming`` posterior to it, on the host sampler.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import config, obs
from pint_tpu_torch.bayesian import BayesianTiming, build_batched_phase_eval
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.models.convert import params_from_packed
from pint_tpu_torch.ops import photon_lnlike
from pint_tpu_torch.ops.dd import dd_add
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.sampler import EnsembleSampler
from pint_tpu_torch.sampling import DeviceEnsembleSampler, DevicePosterior
from pint_tpu_torch.templates import LCGaussian

__all__ = ["MCMCFitter", "PhotonMCMCFitter", "CompositeMCMCFitter",
           "PhotonMetrics", "fused_inputs", "kernel_route"]


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


class PhotonMetrics:
    """Counters of the photon likelihood: bound children of the
    process-global ``obs.metrics`` registry, one
    ``pint_tpu_photon_<name>_total`` each, labelled by a per-instance
    scope, as ``pta.metrics.PTAMetrics`` holds its own; ``snapshot()`` is
    a derived view and every mutation goes through ``bump()``:

    - ``walker_evals``: walker log-likelihoods, each over every photon;
    - ``lnlike_batches``: walker chunks issued, vmapped or fused;
    - ``fused_batches``: the chunks the hand kernel evaluated.
    """

    _COUNTERS = ("walker_evals", "lnlike_batches", "fused_batches")

    def __init__(self):
        from pint_tpu_torch.obs import metrics as om

        self.scope = om.new_scope("photon")
        self._c = {
            name: om.counter(
                f"pint_tpu_photon_{name}_total",
                f"photon likelihood {name.replace('_', ' ')}"
            ).child(scope=self.scope)
            for name in self._COUNTERS}

    def bump(self, name: str, n: int = 1):
        self._c[name].inc(n)

    def snapshot(self) -> dict:
        """Derived view of the registry children."""
        return {name: int(child.value())
                for name, child in self._c.items()}


def _phase_parts(model, pv, rows, cache, sub: str):
    """(Spindown's dd time since PEPOCH, the dd sum of the model's other
    phase components or None) of ``rows``, the TOAs of ``cache``'s part
    ``sub`` ("main" or "tzr"), through the model's delay chain, as
    ``TimingModel._raw_phase_fn`` takes them."""
    spin = model.components["Spindown"]
    _, tb, ctx = model._delay_tb(pv, rows, cache, sub)
    other = None
    for comp in model.phase_components:
        if comp is spin or (sub == "tzr"
                            and not getattr(comp, "apply_to_tzr", True)):
            continue
        p = comp.phase(pv, rows, cache[sub], ctx, tb)
        other = p if other is None else dd_add(other, p)
    return spin.dt(pv, tb), other


def fused_inputs(model, toas, template, weights=None):
    """``photon_lnlike.Inputs`` of this model, TOAs, template and weights,
    on the model's device; or
    None where the kernel cannot evaluate the likelihood: a free
    parameter that is not one of Spindown's F terms (so a free PEPOCH
    too), a template primitive that is not an ``LCGaussian`` or whose
    location lies outside (-1/2, 3/2), more terms or Gaussians than the
    kernel holds, or a delay or another phase component that moves with
    the free terms.

    The photons' time since PEPOCH and the other components' phase are
    evaluated once, at the model's values, through its own delay chain:
    no free parameter enters them, which a second evaluation with every
    free term moved confirms. The walker's terms are Spindown's
    ``f_terms()``."""
    spin = model.components.get("Spindown")
    free, frozen, th, tl, fh, fl = model._pack()
    if spin is None or any(getattr(spin.params.get(n), "prefix", None)
                           != "F" for n in free):
        return None
    prims = template.primitives
    m = len(prims)
    theta = torch.as_tensor(np.asarray(template.theta, dtype=np.float64))
    locs = theta[m + 1:2 * m + 1].tolist()
    terms = spin.f_terms()
    if any(type(p) is not LCGaussian for p in prims) or \
            not 1 <= m <= photon_lnlike.MAX_PEAKS or \
            not all(-0.5 < loc < 1.5 for loc in locs) or \
            not 1 <= len(terms) <= photon_lnlike.MAX_TERMS or \
            not set(terms) <= set(free) | set(frozen):
        return None
    dev = model.device
    cache = model.get_cache(toas, dev)
    subs = [("main", cache["batch"])]
    if "tzr_batch" in cache:
        subs.append(("tzr", cache["tzr_batch"]))
    moved = tl + np.where(th != 0, np.abs(th) * 1e-6, 1e-6)
    with torch.no_grad():
        parts = []
        for lo in (tl, moved):
            pv = params_from_packed(free, frozen, th, lo, fh, fl, device=dev)
            parts.append([_phase_parts(model, pv, rows, cache, sub)
                          for sub, rows in subs])

    def same(a, b):
        return (a is None) == (b is None) and (a is None or (
            torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)))

    if not all(same(a, b) for p, q in zip(*parts) for a, b in zip(p, q)):
        return None
    (dt, other), *tzr_part = parts[0]
    if other is not None and not (other.hi.any() or other.lo.any()):
        other = None
    photons = photon_lnlike.Photons(
        dt.hi.contiguous(), dt.lo.contiguous(),
        *((None, None) if other is None else
          (other.hi.contiguous(), other.lo.contiguous())),
        None if weights is None else torch.as_tensor(
            weights, dtype=torch.float64, device=dev).contiguous())
    tzr = None
    if tzr_part:
        tdt, toth = tzr_part[0]
        tzr = (float(tdt.hi[0]), float(tdt.lo[0]),
               *((0.0, 0.0) if toth is None else
                 (float(toth.hi[0]), float(toth.lo[0]))))
    col = {n: i for i, n in enumerate(free)}
    val = dict(zip(free, zip(th, [0.0] * len(free))))
    val.update(zip(frozen, zip(fh, fl)))
    spin_terms = photon_lnlike.Spin(
        [float(val[n][0]) for n in terms], [float(val[n][1]) for n in terms],
        [col.get(n, -1) for n in terms], tzr)
    return photon_lnlike.Inputs(photons, spin_terms,
                                photon_lnlike.gaussians(theta.tolist(), m))


def kernel_route(model, toas, template, weights=None):
    """The hand kernel's ``fused_inputs`` where ``PhotonMCMCFitter`` takes
    it, on a CUDA model; None where the vmapped path runs."""
    if model.device.type != "cuda":
        return None
    return fused_inputs(model, toas, template, weights)


class PhotonMCMCFitter:
    """Sample timing parameters against an unbinned photon-template
    likelihood (reference: MCMCFitterAnalyticTemplate / event_optimize)
    on the model's device. The phase model is re-evaluated per sample
    through the dd low word (``bayesian.build_batched_phase_eval``).
    Where ``fused_inputs`` finds the likelihood within the hand kernel's
    reach on a CUDA model (``fused`` True), a batch of walkers is one
    kernel call a chunk of ``photon_lnlike.MAX_WALKERS``; otherwise it is
    one vmapped pass of the chain and the template's pdf, in chunks of
    ``config.photon_walker_chunk(N)`` walkers (the result does not depend
    on the chunk).

    ``mode``: "scan" (default) or "host_loop" run
    ``sampling.DeviceEnsembleSampler`` over the batched likelihood;
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
        self.metrics = metrics = PhotonMetrics()

        self.theta0, self._tl0, frac_fn = build_batched_phase_eval(
            model, toas)
        nphot = toas.ntoas
        fused = kernel_route(model, toas, template, weights)
        self.fused = on_kernel = fused is not None
        if on_kernel:
            def core(tl_eff):
                return photon_lnlike.photon_lnlike(fused, tl_eff)

            chunk = photon_lnlike.MAX_WALKERS
        else:
            core = torch.func.vmap(self._vmapped_core(frac_fn, weights))
            chunk = config.photon_walker_chunk(nphot)

        def core_batch(tl_eff):
            out = []
            for i, a in enumerate(range(0, tl_eff.shape[0], chunk)):
                part = tl_eff[a:a + chunk]
                with obs.span("photon.lnlike", walkers=part.shape[0],
                              photons=nphot, chunk=i):
                    out.append(core(part))
                metrics.bump("lnlike_batches")
                if on_kernel:
                    metrics.bump("fused_batches")
            metrics.bump("walker_evals", tl_eff.shape[0])
            return out[0] if len(out) == 1 else torch.cat(out)

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

    def _vmapped_core(self, frac_fn, weights):
        """A walker's log-likelihood from its tl_eff row, through the dd
        phase chain and the template's pdf: the general path, mapped
        under ``torch.func.vmap``."""
        dev = self.device
        w = (torch.ones(self.toas.ntoas, dtype=torch.float64, device=dev)
             if weights is None else
             torch.as_tensor(weights, dtype=torch.float64, device=dev))
        wc = 1.0 - w
        pdf = self.template._pdf_fn()
        ttheta = torch.as_tensor(self.template.theta, dtype=torch.float64,
                                 device=dev)

        def lnlike_core(tl_eff):
            phases = torch.remainder(frac_fn(tl_eff), 1.0)
            dens = pdf(ttheta, phases)
            return torch.sum(torch.log(w * dens + wc))

        return lnlike_core

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
