"""Pulsation-significance statistics over photon phases (a port of
pint_tpu/eventstats.py; reference: src/pint/eventstats.py z2m, hm, hmw,
sig2sigma).

    Z^2_m = (2/W) * sum_{k=1..m} |sum_i w_i e^{2pi i k phi_i}|^2,
    W = sum w_i^2 (weighted; = N unweighted)
    H   = max_{1<=m<=M} (Z^2_m - 4m + 4),  M = 20  (de Jager 1989)

On a CUDA tensor the trig sums always come from the hand-written kernel
(``ops/z2_harmonics.py``), whatever N and m; on the CPU from its plain
float64 version. Significance: P(>H) ~= exp(-0.4 H) (de Jager & Busching
2010); Z^2_m is chi^2 with 2m dof under the null.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops.z2_harmonics import z2_harmonics

__all__ = ["z2m", "hm", "hmw", "h_sig", "sig2sigma", "sf_z2m", "sf_hm",
           "h2sig"]


def _z2_terms(phases: torch.Tensor, weights: torch.Tensor, m: int):
    """Per-harmonic |sum|^2 terms scaled by 2/normalization (de Jager
    1989 weighted form), float64."""
    c, s = z2_harmonics(phases, weights, m)
    norm = torch.sum(weights ** 2)
    return 2.0 * (c ** 2 + s ** 2) / norm


def _as_f64(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


def _phases_weights(phases, weights, device):
    dev = resolve_device(device)
    ph = _as_f64(phases, dev)
    w = torch.ones_like(ph) if weights is None else _as_f64(weights, dev)
    return ph, w


def z2m(phases, m: int = 2, weights=None, device=None) -> float:
    """Z^2_m statistic (reference: eventstats.z2m)."""
    ph, w = _phases_weights(phases, weights, device)
    return float(torch.sum(_z2_terms(ph, w, m)))


def hm(phases, m: int = 20, device=None) -> float:
    """H-test (reference: eventstats.hm)."""
    return hmw(phases, None, m=m, device=device)


def hmw(phases, weights, m: int = 20, device=None) -> float:
    """Weighted H-test (reference: eventstats.hmw)."""
    ph, w = _phases_weights(phases, weights, device)
    z2 = torch.cumsum(_z2_terms(ph, w, m), dim=0)
    ks = torch.arange(1, m + 1, dtype=torch.float64, device=ph.device)
    return float(torch.max(z2 - 4.0 * ks + 4.0))


def sf_hm(h: float) -> float:
    """Null survival probability of the H statistic
    (de Jager & Busching 2010: P ~= exp(-0.4 H))."""
    return float(np.exp(-0.4 * h))


def sf_z2m(z2: float, m: int = 2) -> float:
    """Null survival probability of Z^2_m (chi^2, 2m dof)."""
    from scipy.stats import chi2 as _chi2

    return float(_chi2.sf(z2, 2 * m))


def h_sig(h: float) -> float:
    """H-test significance in Gaussian sigma (computed from
    log P = -0.4 H directly, so huge H never underflows to inf)."""
    return _sigma_from_logsf(-0.4 * float(h))


def sig2sigma(sf: float) -> float:
    """Convert a survival probability to the equivalent one-sided
    Gaussian sigma (reference: eventstats.sig2sigma). Uses log-space
    asymptotics for tiny probabilities."""
    if sf <= 0.0:
        return float("inf")
    return _sigma_from_logsf(np.log(sf))


def _sigma_from_logsf(logsf: float) -> float:
    from scipy.stats import norm as _norm

    if logsf > np.log(1e-300):
        return float(_norm.isf(np.exp(logsf)))
    # asymptotic inversion of the Gaussian tail in log space:
    # sf ~= exp(-x^2/2)/(x sqrt(2pi)) -> x ~= sqrt(-2 ln(sf*sqrt(2pi)x))
    x = np.sqrt(-2.0 * logsf)
    for _ in range(10):
        x = np.sqrt(-2.0 * (logsf + np.log(x * np.sqrt(2 * np.pi))))
    return float(x)


def h2sig(h: float) -> float:
    """Significance in Gaussian sigma of an H-statistic (reference:
    eventstats.h2sig)."""
    return h_sig(h)
