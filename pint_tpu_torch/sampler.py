"""Ensemble MCMC sampler (a port of pint_tpu/sampler.py).

Reference: src/pint/sampler.py (EmceeSampler) — a thin wrapper over the
external emcee package, which does not exist in this stack. This is a
self-contained affine-invariant stretch-move ensemble sampler
(Goodman & Weare 2010, the same algorithm emcee implements), designed
around BATCHED posterior evaluation: each half-ensemble's proposals are
scored in ONE vectorized call (BayesianTiming.lnposterior_batch scores
them in one vmapped pass on the device), so a 64-walker ensemble costs
two calls per step rather than 64 python evaluations. It is numpy: with
the same generator and target it gives the reference's chain bit for
bit.

The whole-chain-on-device variant lives in ``pint_tpu_torch.sampling``;
the chain diagnostics shared by both samplers are the ``ChainStats``
mixin below.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["EnsembleSampler", "ChainStats"]


class ChainStats:
    """Chain bookkeeping + convergence diagnostics shared by the
    host ``EnsembleSampler`` and the device
    ``sampling.DeviceEnsembleSampler`` (emcee-compatible surface:
    ``chain``/``lnprob``/``get_chain``/``get_autocorr_time``/
    ``converged``)."""

    chain: Optional[np.ndarray] = None    # (nsteps, W, ndim)
    lnprob: Optional[np.ndarray] = None   # (nsteps, W)
    naccepted = 0
    niterations = 0

    @property
    def acceptance_fraction(self) -> float:
        return self.naccepted / max(1, self.niterations)

    def get_chain(self, discard: int = 0, thin: int = 1,
                  flat: bool = False) -> np.ndarray:
        """(nsteps, W, ndim) chain view (emcee-compatible API)."""
        if self.chain is None:
            raise ValueError("run_mcmc first")
        c = self.chain[discard::thin]
        return c.reshape(-1, self.ndim) if flat else c

    def get_autocorr_time(self, c: float = 5.0) -> np.ndarray:
        """Integrated autocorrelation time per parameter, estimated
        from the walker-averaged chain with Sokal's self-consistent
        window M >= c*tau (the estimator emcee uses; reference:
        event_optimize's convergence reporting)."""
        if self.chain is None:
            raise ValueError("run_mcmc first")
        nsteps = self.chain.shape[0]
        taus = np.empty(self.ndim)
        for d in range(self.ndim):
            # mean over walkers first: GW ensembles are exchangeable
            x = self.chain[:, :, d].mean(axis=1)
            x = x - x.mean()
            # FFT autocorrelation
            n = 1 << (2 * nsteps - 1).bit_length()
            f = np.fft.rfft(x, n=n)
            acf = np.fft.irfft(f * np.conjugate(f), n=n)[:nsteps]
            if acf[0] <= 0:
                taus[d] = np.nan
                continue
            acf = acf / acf[0]
            cumtau = 2.0 * np.cumsum(acf) - 1.0
            window = np.arange(nsteps) >= c * cumtau
            m = np.argmax(window) if window.any() else nsteps - 1
            taus[d] = max(cumtau[m], 1.0)
        return taus

    def converged(self, factor: float = 50.0, tau=None) -> bool:
        """emcee's rule of thumb: the chain is long enough when
        nsteps > factor * max(tau). Pass a precomputed ``tau`` to
        avoid re-running the FFT autocorrelation."""
        tau = self.get_autocorr_time() if tau is None else \
            np.asarray(tau)
        if not np.all(np.isfinite(tau)):
            return False
        return self.chain.shape[0] > factor * float(np.max(tau))


class EnsembleSampler(ChainStats):
    """Affine-invariant ensemble sampler with batched posterior calls.

    ``log_prob_batch`` maps an (S, ndim) array to (S,) log posteriors.
    """

    def __init__(self, nwalkers: int, ndim: int,
                 log_prob_batch: Callable[[np.ndarray], np.ndarray],
                 a: float = 2.0,
                 rng: Optional[np.random.Generator] = None):
        if nwalkers < 2 * ndim or nwalkers % 2:
            raise ValueError(
                "need an even nwalkers >= 2*ndim for ensemble moves")
        self.nwalkers = nwalkers
        self.ndim = ndim
        self.log_prob_batch = log_prob_batch
        self.a = float(a)
        self.rng = rng or np.random.default_rng()
        self.chain: Optional[np.ndarray] = None   # (nsteps, W, ndim)
        self.lnprob: Optional[np.ndarray] = None  # (nsteps, W)
        self.naccepted = 0
        self.niterations = 0

    def _stretch_half(self, pos, lp, move, other):
        """One stretch-move update of walkers ``move`` against the
        complementary set ``other``; returns accepted count."""
        n = len(move)
        # z ~ g(z) prop. 1/sqrt(z) on [1/a, a]
        z = ((self.a - 1.0) * self.rng.uniform(size=n) + 1.0) ** 2 \
            / self.a
        partners = other[self.rng.integers(0, len(other), size=n)]
        prop = pos[partners] + z[:, None] * (pos[move] - pos[partners])
        # np.array (an owned copy): log_prob_batch may hand back a view
        # of memory it reuses on its next call
        lp_prop = np.array(self.log_prob_batch(prop),
                           dtype=np.float64)
        logq = (self.ndim - 1.0) * np.log(z) + lp_prop - lp[move]
        accept = np.log(self.rng.uniform(size=n)) < logq
        pos[move[accept]] = prop[accept]
        lp[move[accept]] = lp_prop[accept]
        return int(accept.sum())

    def run_mcmc(self, p0: np.ndarray, nsteps: int,
                 progress: bool = False) -> np.ndarray:
        """Run the ensemble; returns the final (W, ndim) positions and
        stores the full chain in ``self.chain``."""
        pos = np.array(p0, dtype=np.float64)
        if pos.shape != (self.nwalkers, self.ndim):
            raise ValueError(f"p0 must be {(self.nwalkers, self.ndim)}")
        # np.array (copy): log_prob_batch may hand back a read-only view
        lp = np.array(self.log_prob_batch(pos), dtype=np.float64)
        if not np.any(np.isfinite(lp)):
            raise ValueError("no walker starts at finite posterior")
        chain = np.empty((nsteps, self.nwalkers, self.ndim))
        lnprob = np.empty((nsteps, self.nwalkers))
        half = self.nwalkers // 2
        first = np.arange(half)
        second = np.arange(half, self.nwalkers)
        for step in range(nsteps):
            self.naccepted += self._stretch_half(pos, lp, first, second)
            self.naccepted += self._stretch_half(pos, lp, second, first)
            self.niterations += self.nwalkers
            chain[step] = pos
            lnprob[step] = lp
            if progress and (step + 1) % max(1, nsteps // 10) == 0:
                print(f"  step {step + 1}/{nsteps} "
                      f"acc={self.acceptance_fraction:.2f}")
        self.chain = chain
        self.lnprob = lnprob
        return pos
