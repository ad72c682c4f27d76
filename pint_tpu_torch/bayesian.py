"""Bayesian timing interface: lnprior / lnlikelihood / lnposterior /
prior_transform over a TimingModel + TOAs (a port of
pint_tpu/bayesian.py; reference: src/pint/bayesian.py BayesianTiming).

The likelihood is a function of tensors on the model's device: the dd
phase chain, the weighted-mean subtraction and the noise-marginalized
Gaussian likelihood. A batch of parameter points is one
``torch.func.vmap`` of that function over the points, so a walker
population is scored in one pass of the chain (the reference evaluates
one point at a time under emcee).

With the noise hyperparameters held fixed (the reference's default
mode), the correlated-noise covariance C = N + F phi F^T is constant
across likelihood calls, so its Woodbury Cholesky factor and log-
determinant are computed once at construction; each call costs one
phase evaluation plus two small matmuls.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from pint_tpu_torch.gls import cho_factor, cho_solve
from pint_tpu_torch.ops.dd import dd_frac
from pint_tpu_torch.parallel.fit_step import SegmentSum

__all__ = ["BayesianTiming", "build_batched_phase_eval", "noise_terms"]

LN2PI = math.log(2.0 * math.pi)


def build_batched_phase_eval(model, toas):
    """(theta0, tl0, frac_fn): the shared sampling plumbing, on the
    model's device. ``frac_fn`` maps tl_eff -> fractional phase (float64,
    N), where tl_eff = tl0 + (theta - theta0) is formed on the HOST — the
    parameter point enters only through the dd LOW word, so every
    representable theta evaluates exactly (putting theta in the hi word
    would quantize perturbations of large parameters to ulp(value), ~0.1
    sigma for F0 at typical MSP precision). ``theta0`` and ``tl0`` are
    float64 numpy arrays; ``frac_fn`` maps under ``torch.func.vmap``
    over a batch of tl_eff rows."""
    dev = model.device
    phase_fn, _ = model._build_phase_fn()
    cache = model.get_cache(toas, dev)
    _, _, th, tl, fh, fl = model._pack()
    batch = cache["batch"]
    sc = {k: v for k, v in cache.items() if k != "batch"}
    th0 = np.asarray(th, dtype=np.float64)
    th0_t, fh_t, fl_t = (torch.as_tensor(np.asarray(x, np.float64),
                                         device=dev)
                         for x in (th0, fh, fl))

    def frac_fn(tl_eff):
        ph = phase_fn(th0_t, tl_eff, fh_t, fl_t, batch, sc)[0]
        f = dd_frac(ph)
        return f.hi + f.lo

    return th0, np.asarray(tl, dtype=np.float64), frac_fn


def noise_terms(model, toas):
    """The white noise and ECORR segment structure both likelihoods share,
    on the model's device: (w, logdet_white, seg, s_seg, jvar, exclude)
    with w = 1/nvec, ``seg`` the SegmentSum over the ECORR epochs (None
    without ECORR segments), s_seg the per-epoch weight sums, jvar the
    per-epoch variances (numpy) and ``exclude`` the components the
    segments consume."""
    dev = model.device
    nvec = torch.as_tensor(model.scaled_toa_uncertainty(toas) ** 2,
                           dtype=torch.float64, device=dev)
    w = 1.0 / nvec
    logdet_white = float(torch.sum(torch.log(nvec)))
    seg = model.noise_model_ecorr_segments(toas)
    if seg is None:
        return w, logdet_white, None, None, None, ()
    eid_np, jvar_np, exclude = seg
    plan = SegmentSum(torch.as_tensor(eid_np, dtype=torch.long,
                                      device=dev), len(jvar_np))
    return w, logdet_white, plan, plan(w), jvar_np, exclude


def _factor(A0, phi, EF, g):
    """(dS, Lf, logdet_sff) of Sff = A0 + diag(1/phi), ECORR-downdated
    by EF^T g EF when ``EF`` is not None: its Jacobi scale, the Cholesky
    factor of the scaled matrix and its log-determinant. The scaling
    matters: raw Sff mixes O(1) data terms with 1/phi priors up to ~1e25
    and a bare Cholesky loses ~4 digits of the quadratic form."""
    Sff = A0 + torch.diag(1.0 / phi)
    if EF is not None:
        Sff = Sff - EF.T @ (g[:, None] * EF)
    dS = torch.sqrt(torch.diagonal(Sff))
    Lf = cho_factor(Sff / torch.outer(dS, dS))
    # logdet Sff = logdet Sp + 2 sum ln dS
    logdet_sff = 2.0 * torch.sum(torch.log(torch.diagonal(Lf))) \
        + 2.0 * torch.sum(torch.log(dS))
    return dS, Lf, logdet_sff


def _quad(r, w, seg, g, Fw, EF, dS, Lf):
    """r^T C^-1 r: the white term, one Sherman-Morrison downdate per
    ECORR epoch (``seg`` None without them) and the Woodbury Fourier
    block (``Fw`` None without one)."""
    rCr = torch.sum(r * r * w)
    if seg is not None:
        wr_seg = seg(w * r)
        rCr = rCr - torch.sum(g * wr_seg ** 2)
    if Fw is not None:
        bF = Fw.T @ r
        if EF is not None:
            bF = bF - EF.T @ (g * wr_seg)
        bF = bF / dS
        rCr = rCr - bF @ cho_solve(Lf, bF)
    return rCr


class BayesianTiming:
    """lnposterior machinery for sampling timing parameters (reference:
    bayesian.BayesianTiming), on the model's device."""

    def __init__(self, model, toas):
        self.model = model
        self.toas = toas
        self.device = dev = model.device
        self.param_labels: List[str] = list(model.free_params)
        self.nparams = len(self.param_labels)
        self._priors = [model.get_param(p).prior
                        for p in self.param_labels]

        free = model._pack()[0]
        if free != self.param_labels:
            raise ValueError(
                "free_params / packed-parameter mismatch: "
                f"{sorted(set(free) ^ set(self.param_labels))}")
        f0 = float(model.F0.value)
        self.theta0, self._tl0, self._frac_fn = build_batched_phase_eval(
            model, toas)
        frac_fn = self._frac_fn

        def f64(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=dev)

        w, logdet_n, seg, s_seg, jvar_np, exclude = noise_terms(model, toas)
        n = toas.ntoas
        # ECORR rides the O(N) Sherman-Morrison segment path exactly as
        # in the fit step (one rank-1 downdate per observing epoch);
        # only the Fourier bases stay dense
        g = EF = None
        if seg is not None:
            jvar = f64(jvar_np)
            g = jvar / (1.0 + jvar * s_seg)
            logdet_n += float(torch.sum(torch.log1p(jvar * s_seg)))
        F = model.noise_model_designmatrix(toas, exclude=exclude)
        # constant noise machinery (hyperparameters fixed during
        # timing-parameter sampling, as in the reference)
        if F is None:
            self._lnnorm = -0.5 * logdet_n - 0.5 * n * LN2PI
            Fw = Lf = dS = None
        else:
            phi = f64(model.noise_model_basis_weight(toas, exclude=exclude))
            Ft = f64(F)
            Fw = Ft * w[:, None]
            if seg is not None:
                EF = seg(Fw)
            dS, Lf, logdet_sff = _factor(Ft.T @ Fw, phi, EF, g)
            # logdet C = logdet N_eff + sum ln phi + logdet Sff
            logdet = (logdet_n + float(torch.sum(torch.log(phi)))
                      + float(logdet_sff))
            self._lnnorm = -0.5 * logdet - 0.5 * n * LN2PI

        lnnorm = self._lnnorm
        # with an explicit PhaseOffset the sampled PHOFF replaces the
        # implicit mean removal — subtracting the mean here would make
        # PHOFF exactly inert in the likelihood
        demean = "PhaseOffset" not in model.components

        def lnlike_core(tl_eff):
            frac = frac_fn(tl_eff)
            if demean:
                frac = frac - torch.sum(frac * w) / torch.sum(w)
            rCr = _quad(frac / f0, w, seg, g, Fw, EF, dS, Lf)
            return -0.5 * rCr + lnnorm

        # the raw closure is the reusable surface: sampling.DevicePosterior
        # composes it into the walker batch
        self._lnlike_core_raw = lnlike_core
        self._lnlike_core_batch = torch.func.vmap(lnlike_core)

    def _tl_eff(self, thetas) -> torch.Tensor:
        """tl0 + (theta - theta0), formed on the host in float64, on the
        device (one point or a batch of rows)."""
        return torch.as_tensor(
            self._tl0 + (np.asarray(thetas, dtype=np.float64)
                         - self.theta0), device=self.device)

    # ------------------------------------------------------------ API

    def lnprior(self, theta) -> float:
        """Sum of per-parameter prior log-densities (reference:
        BayesianTiming.lnprior). None priors (improper flat) contribute
        exactly 0 and are skipped."""
        theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
        total = 0.0
        for p, x in zip(self._priors, theta):
            if p is not None:
                total += float(p.logpdf(float(x)))
        return total

    def prior_transform(self, cube) -> np.ndarray:
        """Unit-cube -> parameter space via per-parameter ppf (for
        nested samplers; reference: BayesianTiming.prior_transform).
        Raises for parameters with improper (None) priors."""
        cube = np.atleast_1d(np.asarray(cube, dtype=np.float64))
        out = np.empty_like(cube)
        for k, (p, q) in enumerate(zip(self._priors, cube)):
            if p is None:
                raise ValueError(
                    f"parameter {self.param_labels[k]} has no proper "
                    "prior; set one for prior_transform")
            out[k] = float(p.ppf(float(q)))
        return out

    def lnlikelihood(self, theta) -> float:
        """Noise-marginalized Gaussian log-likelihood (reference:
        BayesianTiming.lnlikelihood)."""
        return float(self._lnlike_core_raw(self._tl_eff(theta)))

    def lnposterior(self, theta) -> float:
        lp = self.lnprior(theta)
        if not np.isfinite(lp):
            return -np.inf
        return lp + self.lnlikelihood(theta)

    # batch evaluation — one vmapped pass for a whole population

    def lnlikelihood_batch(self, thetas) -> np.ndarray:
        """(S,) log-likelihoods for an (S, nparams) sample batch, one
        vmapped pass of the chain (no reference equivalent)."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        return self._lnlike_core_batch(self._tl_eff(thetas)).cpu().numpy()

    def lnposterior_batch(self, thetas) -> np.ndarray:
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        # priors vectorized per COLUMN over the batch (None = flat = 0)
        lp = np.zeros(len(thetas))
        for k, p in enumerate(self._priors):
            if p is not None:
                lp += p.logpdf(torch.as_tensor(thetas[:, k])).numpy()
        out = np.full(len(thetas), -np.inf)
        ok = np.isfinite(lp)
        if np.any(ok):
            # evaluate the FULL fixed-shape batch (the reference's rule: a
            # masked batch would change shape every step); out-of-bounds
            # rows are simply discarded
            ll = self.lnlikelihood_batch(thetas)
            out[ok] = lp[ok] + ll[ok]
        return out
