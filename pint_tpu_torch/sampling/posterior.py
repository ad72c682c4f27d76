"""The posterior the device sampler evaluates (a port of
pint_tpu/sampling/posterior.py; reference: src/pint/bayesian.py +
src/pint/mcmc_fitter.py).

The whole lnposterior — the priors of ``models.priors`` as torch ops
plus the noise-marginalized likelihood — is one function of a walker's
parameter vector, ``lnpost_one``, and ``lnpost_batch`` is its
``torch.func.vmap`` over a (W, ndim) batch: the chain of
``sampling.chain`` scores a half-ensemble in one pass of the dd chain.

Two modes:

- fixed noise (default): wraps ``BayesianTiming``'s likelihood closure —
  hyperparameters frozen at construction, exactly the reference's
  sampling mode;
- ``sample_noise=True``: appends the GP noise hyperparameters
  (PLRedNoise log10_A/gamma, ECORR weights) as sampled dimensions via
  ``SampledNoiseLikelihood`` — phi, the per-epoch variances, the Sff
  Cholesky and the log-determinant recomputed per walker.

A walker outside a prior's support, or whose Sff is not positive
definite, scores -inf or NaN: the chain never accepts either.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pint_tpu_torch.bayesian import BayesianTiming
from pint_tpu_torch.sampling.likelihood import SampledNoiseLikelihood

__all__ = ["DevicePosterior"]


class DevicePosterior:
    """lnposterior as a batch function (W, ndim) -> (W,) on the model's
    device.

    ``param_labels`` orders theta: the model's free timing parameters
    (BayesianTiming validates the packed order), then — with
    ``sample_noise`` — the noise labels of ``SampledNoiseLikelihood``.
    ``theta0`` is the current point.
    """

    def __init__(self, model, toas, sample_noise: bool = False):
        self.model = model
        self.toas = toas
        self.device = dev = model.device
        self.bt = BayesianTiming(model, toas)
        self.sample_noise = bool(sample_noise)
        ntim = self.bt.nparams
        self.ntiming = ntim
        th0_t = torch.as_tensor(self.bt.theta0, device=dev)
        tl0_t = torch.as_tensor(self.bt._tl0, device=dev)
        priors: List = list(self.bt._priors)
        labels = list(self.bt.param_labels)
        theta0 = np.asarray(self.bt.theta0, dtype=np.float64)

        if sample_noise:
            self.noise = SampledNoiseLikelihood(model, toas, bt=self.bt)
            labels += self.noise.labels
            theta0 = np.concatenate([theta0, self.noise.eta0])
            priors += self.noise.priors
            core = self.noise.lnlike_core

            def lnlike(theta):
                return core(tl0_t + (theta[:ntim] - th0_t), theta[ntim:])
        else:
            self.noise = None
            core = self.bt._lnlike_core_raw

            def lnlike(theta):
                return core(tl0_t + (theta - th0_t))

        def lnpost_one(theta):
            lp = _prior_sum(priors, theta)
            ll = lnlike(theta)
            return torch.where(torch.isfinite(lp), lp + ll,
                               torch.full_like(ll, -np.inf))

        self.param_labels = labels
        self.nparams = len(labels)
        self.theta0 = theta0
        self._priors = priors
        self.lnpost_one = lnpost_one
        self.lnpost_batch = torch.func.vmap(lnpost_one)

    def init_scales(self) -> np.ndarray:
        """Per-dimension walker-scatter scales: the parameter's quoted
        uncertainty when it has one, a relative floor otherwise; noise
        dimensions (log10/spectral-index units, all O(1)) default to
        0.1."""
        scales = np.empty(self.nparams)
        for k, name in enumerate(self.param_labels):
            if k < self.ntiming:
                p = self.model.get_param(name)
                scales[k] = p.uncertainty if p.uncertainty else \
                    max(abs(self.theta0[k]) * 1e-10, 1e-14)
            else:
                scales[k] = 0.1
        return scales

    def init_walkers(self, nwalkers: int,
                     rng: Optional[np.random.Generator] = None,
                     scatter: float = 0.5) -> np.ndarray:
        """(nwalkers, ndim) starting positions around ``theta0``, drawn
        from ``rng`` (numpy), as the reference draws them."""
        rng = rng or np.random.default_rng()
        return self.theta0[None, :] + scatter \
            * self.init_scales()[None, :] \
            * rng.standard_normal((nwalkers, self.nparams))


def _prior_sum(priors, theta):
    """Sum of per-parameter prior log-densities (None = improper flat =
    exactly 0, the BayesianTiming convention)."""
    lp = theta.new_zeros(())
    for k, p in enumerate(priors):
        if p is not None:
            lp = lp + p.logpdf(theta[k])
    return lp
