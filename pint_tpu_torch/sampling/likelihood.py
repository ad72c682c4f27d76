"""GP noise-hyperparameter sampled likelihood (a port of
pint_tpu/sampling/likelihood.py).

Reference: src/pint/bayesian.py (BayesianTiming) + the standard
red-noise analysis of van Haasteren et al. (arXiv:1202.5932) with the
low-rank Woodbury evaluation of arXiv:1407.6710: the fixed-noise
``BayesianTiming`` freezes ``phi`` and the Woodbury Cholesky at
construction; here the pieces that depend on the sampled
hyperparameters — the power-law ``phi`` of each PLRedNoise basis, the
per-epoch ECORR variances, the Sff Cholesky and the log-determinant —
are computed inside the likelihood, so log10_A/gamma and the ECORR
weights become sampled dimensions evaluated per walker under
``torch.func.vmap``.

What stays static (hyperparameters not sampled here, exactly the split
the Woodbury algebra allows): the white-noise vector ``nvec``
(EFAC/EQUAD), the Fourier bases (they depend on the TOA grid, not on
amplitudes), the data-side normal block F^T N^-1 F, and the per-epoch
weight sums the Sherman-Morrison ECORR downdate consumes. The per-sample
recompute is one q x q Cholesky plus O(q^2) assembly. A Sff that is not
positive definite gives a NaN likelihood for that walker (``gls.
cho_factor``), which the chain never accepts.

Oracle: at hyperparameters pinned to the model's current values,
``lnlike_core(tl_eff, eta0)`` equals the fixed-noise
``BayesianTiming.lnlikelihood``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from pint_tpu_torch.bayesian import LN2PI, _factor, _quad, \
    build_batched_phase_eval, noise_terms
from pint_tpu_torch.models.noise import FYR, _tdb_seconds, \
    create_fourier_design_matrix, quantization_buckets
from pint_tpu_torch.models.priors import Log10TransformedPrior

__all__ = ["SampledNoiseLikelihood"]


def _powerlaw(f, lgA, gamma):
    """Power-law PSD of a log10 amplitude (models.noise.powerlaw's
    formula): P(f) = A^2/(12 pi^2) f_yr^(gamma-3) f^(-gamma)."""
    A2 = 10.0 ** (2.0 * lgA)
    return A2 / (12.0 * math.pi ** 2) * FYR ** (gamma - 3.0) \
        * f ** (-gamma)


def _ecorr_epoch_params(model, toas, jvar_np):
    """(ep_param, ec_params): the ECORR parameter of every epoch of
    ``noise_model_ecorr_segments``, replayed in exactly its enumeration
    order (components in model order, params in ecorrs order,
    quantization buckets per mask) and VERIFIED against the returned
    jvar, so any reordering fails loudly instead of silently sampling
    the wrong epoch's weight."""
    mjd = toas.get_mjds()
    ep_param: List[int] = []
    ec_params = []
    for c in model.noise_components:
        if not hasattr(c, "noise_epoch_segments"):
            continue
        for name in getattr(c, "ecorrs", ()):
            p = c.params[name]
            if p.value is None:
                continue
            idx = np.flatnonzero(p.select_mask(toas))
            if len(idx) == 0:
                continue
            nb = len(quantization_buckets(mjd[idx]))
            if nb == 0:
                continue
            ep_param.extend([len(ec_params)] * nb)
            ec_params.append(p)
    if len(ep_param) != len(jvar_np) - 1:
        raise RuntimeError(
            "ECORR epoch enumeration drifted from "
            "noise_model_ecorr_segments "
            f"({len(ep_param)} vs {len(jvar_np) - 1} epochs)")
    for e, pi in enumerate(ep_param):
        expect = (ec_params[pi].value * 1e-6) ** 2
        # atol=0: numpy's default atol (1e-8 s^2) would pass any ECORR
        # variance (~1e-12 s^2), as it does in the reference (ROADMAP.md)
        if not np.isclose(jvar_np[e], expect, rtol=1e-12, atol=0.0):
            raise RuntimeError(
                f"ECORR epoch->parameter map mismatch at epoch {e}")
    return ep_param, ec_params


class SampledNoiseLikelihood:
    """Likelihood with PLRedNoise (log10_A, gamma) and ECORR (log10
    weight) as sampled dimensions, on the model's device.

    ``lnlike_core(tl_eff, eta)`` is the tensor surface: ``tl_eff`` the dd
    low-word parameter point (see ``bayesian.build_batched_phase_eval``),
    ``eta`` the noise vector laid out as ``labels`` reports — one
    ``<ECORR param>.log10`` per active ECORR mask parameter (the weight
    sampled as log10 of the microsecond amplitude), then per PLRedNoise
    component ``<comp>.log10_A`` / ``<comp>.gamma``. ``eta0`` holds the
    model's current values, the pinned-hyperparameter oracle point."""

    def __init__(self, model, toas, bt=None):
        self.model = model
        self.toas = toas
        self.device = dev = model.device
        if bt is not None:
            # reuse the caller's BayesianTiming phase-eval surface (two
            # theta0/tl0 copies that must stay identical otherwise)
            self.theta0, self.tl0, frac_fn = \
                bt.theta0, bt._tl0, bt._frac_fn
        else:
            self.theta0, self.tl0, frac_fn = build_batched_phase_eval(
                model, toas)

        def f64(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=dev)

        w, logdet_white, seg, s_seg, jvar_np, exclude = noise_terms(
            model, toas)
        n = toas.ntoas
        f0 = float(model.F0.value)

        # -- ECORR: segment path with per-epoch variances sampled ----
        labels: List[str] = []
        eta0: List[float] = []
        priors: List = []
        if seg is not None:
            ep_param, ec_params = _ecorr_epoch_params(model, toas, jvar_np)
            for p in ec_params:
                labels.append(f"{p.name}.log10")
                eta0.append(float(np.log10(p.value)))
                # the parameter's prior is declared over the LINEAR
                # ECORR value (microseconds); the sampled dimension is
                # log10(us), so a set prior needs the change-of-variables
                # Jacobian. None stays the improper flat — flat in log10
                # is the standard log-uniform choice for a scale
                # hyperparameter.
                pb = getattr(p, "prior", None)
                priors.append(None if pb is None
                              else Log10TransformedPrior(pb))
            ep_param_t = torch.as_tensor(ep_param, dtype=torch.long,
                                         device=dev)
            n_ecorr = len(ec_params)
        else:
            n_ecorr = 0

        # -- basis components: static F, phi sampled for PLRedNoise --
        pairs = model.noise_model_basis_weight_pairs(toas, exclude=exclude)
        if not pairs and seg is None:
            raise ValueError(
                "model has no sampled noise dimensions (no basis "
                "noise component and no ECORR segments)")
        comps = {type(c).__name__: c for c in model.noise_components}
        phi_parts = []   # static phi, or (freqs, df, eta offset)
        for name, F, phi in pairs:
            comp = comps[name]
            A_g = getattr(comp, "amplitude_gamma", None)
            if A_g is not None and A_g()[0] is not None:
                A, gamma = A_g()
                nmodes = int(comp.TNREDC.value or 30)
                Fc, freqs = create_fourier_design_matrix(
                    _tdb_seconds(toas), nmodes)
                if not np.allclose(Fc, np.asarray(F)):
                    raise RuntimeError(
                        f"{name}: recomputed Fourier basis drifted "
                        f"from noise_basis_weight")
                phi_parts.append((f64(freqs), float(freqs[0]),
                                  len(labels)))
                labels.append(f"{name}.log10_A")
                eta0.append(float(np.log10(A)))
                priors.append(getattr(comp.TNREDAMP, "prior", None)
                              if comp.TNREDAMP.value is not None
                              else None)
                labels.append(f"{name}.gamma")
                eta0.append(float(gamma))
                priors.append(getattr(comp.TNREDGAM, "prior", None)
                              if comp.TNREDGAM.value is not None
                              else None)
            else:
                phi_parts.append(f64(phi))
        if not labels:
            raise ValueError(
                "model has no sampled noise dimensions (no "
                "PLRedNoise amplitude and no ECORR weights)")
        self.labels = labels
        self.eta0 = np.asarray(eta0, dtype=np.float64)
        self.priors = priors
        self.nnoise = len(labels)

        if pairs:
            F_all = f64(np.concatenate([np.asarray(F) for _, F, _ in pairs],
                                       axis=1))
            Fw = F_all * w[:, None]
            A0 = F_all.T @ Fw           # data block: static
            EF = seg(Fw) if seg is not None else None
        else:
            Fw = EF = None

        demean = "PhaseOffset" not in model.components

        def lnlike_core(tl_eff, eta):
            """The noise-sampled log-likelihood (see the class
            docstring): BayesianTiming's fixed-noise core with phi, the
            ECORR variances, Sff and the logdet recomputed from
            ``eta``."""
            # per-epoch ECORR variances + Sherman-Morrison terms
            g = None
            logdet = logdet_white
            if seg is not None:
                jv_ep = (10.0 ** eta[:n_ecorr] * 1e-6) ** 2
                jv = torch.cat([jv_ep[ep_param_t], jv_ep.new_zeros(1)])
                g = jv / (1.0 + jv * s_seg)
                logdet = logdet + torch.sum(torch.log1p(jv * s_seg))
            dS = Lf = None
            if Fw is not None:
                # phi with the sampled power-law blocks put in
                phi = torch.cat([
                    part if torch.is_tensor(part)
                    else _powerlaw(part[0], eta[part[2]],
                                   eta[part[2] + 1]) * part[1]
                    for part in phi_parts])
                dS, Lf, logdet_sff = _factor(A0, phi, EF, g)
                logdet = logdet + torch.sum(torch.log(phi)) + logdet_sff
            lnnorm = -0.5 * logdet - 0.5 * n * LN2PI
            frac = frac_fn(tl_eff)
            if demean:
                frac = frac - torch.sum(frac * w) / torch.sum(w)
            rCr = _quad(frac / f0, w, seg, g, Fw, EF, dS, Lf)
            return -0.5 * rCr + lnnorm

        self.lnlike_core = lnlike_core

    def lnlikelihood(self, theta, eta) -> float:
        """One point on the model's device (the oracle surface),
        supervised like every other device call (key
        ``sampling.lnlike``; no host failover, as in the reference)."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import get_supervisor

        dev = self.device
        tl_eff = self.tl0 + (np.asarray(theta, dtype=np.float64)
                             - self.theta0)

        def run():
            return self.lnlike_core(
                torch.as_tensor(tl_eff, device=dev),
                torch.as_tensor(np.asarray(eta, dtype=np.float64),
                                device=dev))

        with obs.span("sampling.lnlike"):
            return float(get_supervisor().dispatch(
                run, key="sampling.lnlike", device=dev))
