"""Analysis utilities: F-test, DMX parsing/statistics, weighted stats
(a port of pint_tpu/utils.py, host numpy as there).

Reference: src/pint/utils.py (FTest, dmxparse, weighted_mean,
split_prefixed_name, taylor_horner, taylor_horner_deriv). The last three
live in pint_tpu_torch.models.parameter and pint_tpu_torch.ops.taylor
and are re-exported here; the Taylor series there take tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_tpu_torch.models.parameter import split_prefixed_name  # noqa: F401
from pint_tpu_torch.ops.taylor import (  # noqa: F401
    taylor_horner,
    taylor_horner_deriv,
)

__all__ = ["FTest", "weighted_mean", "dmxparse",
           "get_highest_density_range",
           "split_prefixed_name", "taylor_horner", "taylor_horner_deriv",
           "format_uncertainty", "dmx_ranges", "add_dmx_ranges",
           "wavex_setup", "dmwavex_setup",
           "akaike_information_criterion",
           "bayesian_information_criterion", "PosVel"]


def get_highest_density_range(mjds, ndays: float = 7.0):
    """(start, end) MJD of the ``ndays``-wide window holding the most
    TOAs (reference: utils.get_highest_density_range — used to pick a
    TZR region). Sliding-window count over sorted epochs; ties go to
    the earliest window."""
    m = np.sort(np.asarray(mjds, dtype=np.float64))
    if m.size == 0:
        raise ValueError("no MJDs given")
    counts = np.searchsorted(m, m + float(ndays), side="right") \
        - np.arange(m.size)
    k = int(np.argmax(counts))
    return float(m[k]), float(m[k] + float(ndays))


def FTest(chi2_1: float, dof_1: int, chi2_2: float, dof_2: int) -> float:
    """F-test probability that the chi2 improvement from model 1 to the
    (larger) model 2 arises by chance (reference: utils.FTest). Small
    values favor keeping model 2's extra parameters."""
    from scipy.stats import f as fdist

    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_dof <= 0 or dof_2 <= 0:
        raise ValueError("model 2 must have more free parameters")
    if delta_chi2 <= 0:
        return 1.0
    F = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(fdist.sf(F, delta_dof, dof_2))


def weighted_mean(arr, sigma, axis=None):
    """(mean, stderr) with 1/sigma^2 weights (reference:
    utils.weighted_mean)."""
    arr = np.asarray(arr, dtype=np.float64)
    w = 1.0 / np.asarray(sigma, dtype=np.float64) ** 2
    wsum = np.sum(w, axis=axis)
    mean = np.sum(arr * w, axis=axis) / wsum
    return mean, np.sqrt(1.0 / wsum)


def dmxparse(fitter) -> dict:
    """Collect DMX windows from a fitted model: per-window value,
    (covariance-corrected) uncertainty, epoch range and center
    (reference: utils.dmxparse). Returns dict of arrays:
    dmxs, dmx_verrs, dmxeps (centers), r1s, r2s, bins."""
    model = fitter.model
    comp = model.components.get("DispersionDMX")
    if comp is None or not comp.dmx_ids:
        raise ValueError("model has no DMX windows")
    names = ["Offset"] + list(model.free_params)
    cov = fitter.parameter_covariance_matrix
    dmxs, verrs, eps, r1s, r2s, bins = [], [], [], [], [], []
    # mean-subtraction covariance correction (reference dmxparse):
    # var(DMX_i - <DMX>) needs the full DMX block of the covariance
    free_dmx = [f"DMX_{istr}" for _, istr in comp.dmx_ids
                if not comp.params[f"DMX_{istr}"].frozen]
    idx = [names.index(nm) for nm in free_dmx] \
        if cov is not None and all(nm in names for nm in free_dmx) \
        else []
    sub = cov[np.ix_(idx, idx)] if idx else None
    mean_var = float(np.mean(sub)) if sub is not None and len(idx) \
        else 0.0
    k = 0
    for _, istr in comp.dmx_ids:
        p = comp.params[f"DMX_{istr}"]
        r1 = comp.params[f"DMXR1_{istr}"].value
        r2 = comp.params[f"DMXR2_{istr}"].value
        dmxs.append(p.value)
        r1s.append(r1)
        r2s.append(r2)
        eps.append(0.5 * (r1 + r2))
        bins.append(istr)
        if not p.frozen and sub is not None and k < len(idx):
            var = sub[k, k] - 2.0 * float(np.mean(sub[k])) + mean_var
            verrs.append(np.sqrt(max(var, 0.0)))
            k += 1
        else:
            verrs.append(p.uncertainty if p.uncertainty else 0.0)
    return {"dmxs": np.array(dmxs), "dmx_verrs": np.array(verrs),
            "dmxeps": np.array(eps), "r1s": np.array(r1s),
            "r2s": np.array(r2s), "bins": bins,
            "mean_dmx": float(np.mean(dmxs))}


def format_uncertainty(value: float, unc: Optional[float],
                       sig_digits: int = 2) -> str:
    """Compact parenthesized-uncertainty notation used in pulsar
    publication tables: 1.234567(89) means 1.234567 +- 0.000089
    (reference: pintpublish's table formatting). With no uncertainty,
    plain repr of the value."""
    if unc is None or not np.isfinite(unc) or unc <= 0:
        return repr(float(value))
    exp = int(np.floor(np.log10(unc)))
    # decimals so the uncertainty shows sig_digits digits
    dec = max(0, sig_digits - 1 - exp)
    udigits = int(round(unc * 10 ** dec))
    if udigits >= 10 ** sig_digits:  # rounding bumped a digit
        udigits //= 10
        dec -= 1
        if dec < 0:
            dec = 0
            udigits = int(round(unc))
    if dec == 0:
        return f"{value:.0f}({udigits})"
    return f"{value:.{dec}f}({udigits})"


def dmx_ranges(toas, max_window_days: float = 14.0,
               min_gap_days: float = 0.1):
    """Auto-generate DMX windows from TOA epochs: cluster MJDs into
    groups no wider than ``max_window_days``, one (r1, r2) window per
    group padded by ``min_gap_days`` (reference: utils.dmx_ranges)."""
    mjds = np.sort(np.unique(np.asarray(toas.get_mjds())))
    if len(mjds) == 0:
        return []
    clusters = []
    start = prev = mjds[0]
    for m in mjds[1:]:
        if m - start > max_window_days:
            clusters.append((start, prev))
            start = m
        prev = m
    clusters.append((start, prev))
    # pad, but never past the midpoint to the neighboring cluster —
    # densely sampled data would otherwise get overlapping windows
    # (a TOA in two windows makes two degenerate DMX columns)
    ranges = []
    for i, (c1, c2) in enumerate(clusters):
        lo = c1 - min_gap_days
        hi = c2 + min_gap_days
        if i > 0:
            lo = max(lo, 0.5 * (clusters[i - 1][1] + c1))
        if i < len(clusters) - 1:
            hi = min(hi, 0.5 * (c2 + clusters[i + 1][0]))
        ranges.append((lo, hi))
    return ranges


def add_dmx_ranges(model, toas, max_window_days: float = 14.0,
                   frozen: bool = False) -> int:
    """Attach auto-generated DMX windows to the model's DispersionDMX
    component (created if absent); returns the number of windows."""
    from pint_tpu_torch.models.dispersion import DispersionDMX

    comp = model.components.get("DispersionDMX")
    if comp is None:
        comp = DispersionDMX()
        model.add_component(comp, setup=False)
    # one past the highest existing index: the count would collide
    # with (and overwrite) existing windows when indices have gaps
    start = max((i for i, _ in comp.dmx_ids), default=0)
    ranges = dmx_ranges(toas, max_window_days=max_window_days)
    for k, (r1, r2) in enumerate(ranges):
        comp.add_dmx_range(start + k + 1, r1, r2, value=0.0,
                           frozen=frozen)
    comp.setup()
    model.invalidate_cache()
    return len(ranges)


def wavex_setup(model, t_span_days: float, n_freqs: int,
                frozen: bool = False) -> list:
    """Attach a WaveX component with harmonically spaced frequencies
    k/T, k=1..n (reference: utils.wavex_setup). Returns the
    frequencies in 1/day."""
    from pint_tpu_torch.models.components_extra import WaveX

    comp = model.components.get("WaveX")
    if comp is None:
        comp = WaveX()
        model.add_component(comp, setup=False)
    freqs = [k / t_span_days for k in range(1, n_freqs + 1)]
    for f in freqs:
        comp.add_wavex_component(f, frozen=frozen)
    comp.setup()
    model.invalidate_cache()
    return freqs


def dmwavex_setup(model, t_span_days: float, n_freqs: int,
                  frozen: bool = False) -> list:
    """Attach a DMWaveX component with frequencies k/T (reference:
    utils.dmwavex_setup)."""
    from pint_tpu_torch.models.components_extra import DMWaveX

    comp = model.components.get("DMWaveX")
    if comp is None:
        comp = DMWaveX()
        model.add_component(comp, setup=False)
    freqs = [k / t_span_days for k in range(1, n_freqs + 1)]
    for f in freqs:
        comp.add_dmwavex_component(f, frozen=frozen)
    comp.setup()
    model.invalidate_cache()
    return freqs


def akaike_information_criterion(fitter) -> float:
    """AIC = 2k + chi2 for the fitted model (Gaussian likelihood up to
    a constant; reference: utils.akaike_information_criterion)."""
    k = len(fitter.model.free_params)
    return 2.0 * k + float(fitter.resids.chi2)


def bayesian_information_criterion(fitter) -> float:
    """BIC = k ln N + chi2 (reference: utils.bic)."""
    k = len(fitter.model.free_params)
    n = fitter.toas.ntoas
    return k * float(np.log(n)) + float(fitter.resids.chi2)


class PosVel:
    """Minimal 6-vector position/velocity with frame bookkeeping
    (reference: utils.PosVel): supports +/- chaining with
    origin/destination checking, dot products, and numpy access."""

    def __init__(self, pos, vel, origin=None, obj=None):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.vel = np.asarray(vel, dtype=np.float64)
        self.origin = origin
        self.obj = obj

    def __add__(self, other: "PosVel") -> "PosVel":
        if self.obj is not None and other.origin is not None and \
                self.obj != other.origin:
            raise ValueError(
                f"cannot chain {self.origin}->{self.obj} with "
                f"{other.origin}->{other.obj}")
        return PosVel(self.pos + other.pos, self.vel + other.vel,
                      origin=self.origin, obj=other.obj)

    def __sub__(self, other: "PosVel") -> "PosVel":
        if self.origin is not None and other.origin is not None and \
                self.origin != other.origin:
            raise ValueError("subtraction needs a common origin")
        return PosVel(self.pos - other.pos, self.vel - other.vel,
                      origin=other.obj, obj=self.obj)

    def __neg__(self) -> "PosVel":
        return PosVel(-self.pos, -self.vel, origin=self.obj,
                      obj=self.origin)

    def __repr__(self):
        return (f"PosVel({self.origin or '?'} -> {self.obj or '?'}, "
                f"|r|={np.linalg.norm(self.pos, axis=-1)!r})")
