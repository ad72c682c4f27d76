"""Residuals: phase and time residuals, chi-square (a port of
pint_tpu/residuals.py; reference: src/pint/residuals.py
Residuals.calc_phase_resids, calc_time_resids, rms_weighted, chi2).

Phase arithmetic stays in double-double until the fractional part is
extracted; everything after (means, chi2) is float64 on the model's
device, so the residual vector never leaves it.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.phase import Phase

__all__ = ["Residuals"]


class Residuals:
    """Timing residuals of `toas` under `model`, as float64 tensors on
    ``device`` (the model's by default).

    track_mode: "nearest" assigns each TOA to the nearest integer pulse;
    "use_pulse_numbers" uses -pn flags (reference: track_mode).
    """

    def __init__(self, toas, model, track_mode: Optional[str] = None,
                 subtract_mean: Optional[bool] = None,
                 use_weighted_mean: bool = True, device=None):
        self.toas = toas
        self.model = model
        self.device = model.device if device is None \
            else resolve_device(device)
        if track_mode is None:
            track_mode = ("use_pulse_numbers"
                          if toas.get_pulse_numbers() is not None
                          else "nearest")
        self.track_mode = track_mode
        if subtract_mean is None:
            # with an explicit PhaseOffset the fitted PHOFF replaces the
            # implicit mean removal (reference semantics)
            subtract_mean = "PhaseOffset" not in model.components
        self.subtract_mean = subtract_mean
        self.use_weighted_mean = use_weighted_mean
        self._phase_resids = None
        self._time_resids = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64),
                               device=self.device)

    # -- lazy computation ---------------------------------------------

    def calc_phase_resids(self) -> torch.Tensor:
        """Residual phase [turns], mean-subtracted."""
        ph = self.model.phase(self.toas, abs_phase=True, device=self.device)
        if self.track_mode == "use_pulse_numbers":
            pn = self.toas.get_pulse_numbers()
            if pn is None:
                raise ValueError("track_mode=use_pulse_numbers but no "
                                 "-pn flags on these TOAs")
            pn = self._tensor(pn)
        elif self.track_mode == "nearest":
            pn = None
        else:
            raise ValueError(f"unknown track_mode {self.track_mode!r}")
        full = tracked_phase(ph, pn, padd_turns(self.toas, self.device))
        if self.subtract_mean:
            full = full - self._mean(full)
        return full

    def _mean(self, x):
        if not self.use_weighted_mean:
            return x.mean()
        err = self.toas.get_errors()
        if np.any(err == 0):
            return x.mean()
        w = 1.0 / self._tensor(err) ** 2
        return torch.sum(x * w) / torch.sum(w)

    @property
    def phase_resids(self) -> torch.Tensor:
        if self._phase_resids is None:
            self._phase_resids = self.calc_phase_resids()
        return self._phase_resids

    def calc_time_resids(self) -> torch.Tensor:
        """Residuals in seconds: phase / F0."""
        return self.phase_resids / self.model.F0.value

    @property
    def time_resids(self) -> torch.Tensor:
        if self._time_resids is None:
            self._time_resids = self.calc_time_resids()
        return self._time_resids

    # -- summary stats -------------------------------------------------

    @property
    def resids_us(self) -> torch.Tensor:
        return self.time_resids * 1e6

    def rms_weighted(self) -> float:
        """Weighted RMS [s] (reference: Residuals.rms_weighted)."""
        err_s = self.toas.get_errors() * 1e-6
        r = self.time_resids
        if np.any(err_s == 0):
            return float(torch.sqrt(torch.mean(r ** 2)))
        w = 1.0 / self._tensor(err_s) ** 2
        wmean = torch.sum(r * w) / torch.sum(w)
        return float(torch.sqrt(torch.sum(w * (r - wmean) ** 2)
                                / torch.sum(w)))

    def rms(self) -> float:
        return float(torch.sqrt(torch.mean(self.time_resids ** 2)))

    @property
    def chi2(self) -> float:
        """chi2 of the residuals: with correlated-noise components the
        basis-marginalized GLS chi2 r^T C^-1 r, otherwise the white chi2
        against the scaled TOA errors."""
        if self.model.has_correlated_errors:
            from pint_tpu_torch.gls import gls_chi2

            # the residual pass itself runs inside gls_chi2's dispatch
            return gls_chi2(self.model, self.toas, resids=self,
                            device=self.device)
        err_s = self._tensor(self.model.scaled_toa_uncertainty(self.toas))
        return float(torch.sum((self.time_resids / err_s) ** 2))

    def _scaled_errors_s(self) -> np.ndarray:
        """Per-TOA sigma [s]: the model's EFAC/EQUAD-scaled ones, else
        the raw TOA errors."""
        scaled = None
        if hasattr(self.model, "scaled_toa_uncertainty"):
            try:
                scaled = self.model.scaled_toa_uncertainty(self.toas)
            except Exception:
                scaled = None
        if scaled is not None:
            return np.asarray(scaled)
        return self.toas.get_errors() * 1e-6

    def ecorr_average(self, use_noise_model: bool = True,
                      max_gap_days: float = 0.5) -> dict:
        """Epoch-averaged residuals (reference: Residuals.ecorr_average):
        the weighted average of the residuals in each ECORR epoch (or,
        without ECORR segments or with use_noise_model=False, in each
        gap-separated observing epoch). TOAs in no ECORR epoch stay
        unaveraged.

        The epoch sums run on the residuals' device, in a fixed order
        (parallel.fit_step.SegmentSum). Returns a dict over epochs, in
        order of time: mjds (weighted mean), time_resids [s], errors [s]
        (1/sqrt(sum w) plus the epoch's ECORR variance) and freqs
        (weighted mean) as float64 tensors on the device; n (counts) as
        a numpy array and indices as a list of numpy index arrays."""
        from pint_tpu_torch.models.noise import quantization_buckets
        from pint_tpu_torch.parallel.fit_step import SegmentSum

        err_s = self._scaled_errors_s()
        if np.any(err_s == 0):
            raise ValueError(
                "ecorr_average needs nonzero TOA uncertainties "
                "(weighted averaging is undefined at zero error)")
        mjds = np.asarray(self.toas.get_mjds())
        seg = None
        if use_noise_model:
            seg = self.model.noise_model_ecorr_segments(self.toas)
            if seg is None and "EcorrNoise" in self.model.components:
                warnings.warn(
                    "model has ECORR but its epochs overlap (dense-basis "
                    "fallback); epoch-averaged errors will NOT include "
                    "the correlated term", stacklevel=2)
        if seg is not None:
            eid = np.asarray(seg[0], np.int64)
            jvar = np.asarray(seg[1], np.float64)  # last: 'no epoch'
        else:
            buckets = quantization_buckets(mjds, dt_days=max_gap_days,
                                           nmin=1)
            eid = np.empty(len(mjds), np.int64)
            for k, b in enumerate(buckets):
                eid[b] = k
            # every bucket is an epoch; the last slot stays empty
            jvar = np.zeros(len(buckets) + 1)
        nseg = len(jvar)
        counts = np.bincount(eid, minlength=nseg)
        members = np.split(np.argsort(eid, kind="stable"),
                           np.cumsum(counts)[:-1])
        epochs = np.flatnonzero(counts[:-1])
        singles = members[-1]

        w = 1.0 / self._tensor(err_s) ** 2
        cols = torch.stack([w, w * self._tensor(mjds),
                            w * self.time_resids,
                            w * self._tensor(self.toas.get_freqs())], dim=1)
        plan = SegmentSum(torch.as_tensor(eid, device=self.device), nseg)
        sums = torch.cat([
            plan(cols)[torch.as_tensor(epochs, device=self.device)],
            cols[torch.as_tensor(singles, device=self.device)]])
        evar = self._tensor(np.concatenate([jvar[epochs],
                                            np.zeros(len(singles))]))
        wsum = sums[:, 0]
        out = {"mjds": sums[:, 1] / wsum,
               "time_resids": sums[:, 2] / wsum,
               "errors": torch.sqrt(1.0 / wsum + evar),
               "freqs": sums[:, 3] / wsum}
        indices = [members[k] for k in epochs] + \
            [np.array([i]) for i in singles]
        n = np.concatenate([counts[epochs], np.ones(len(singles), int)])
        order = np.argsort(out["mjds"].cpu().numpy())
        order_t = torch.as_tensor(order, device=self.device)
        out = {k: v[order_t] for k, v in out.items()}
        out["n"] = n[order]
        out["indices"] = [indices[i] for i in order]
        return out

    @property
    def dof(self) -> int:
        return self.toas.ntoas - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof


def padd_turns(toas, device):
    """The per-TOA phase adjustments of tim-file PHASE commands (-padd
    flags, turns) as a float64 tensor on ``device``, or None without
    any."""
    padd = np.array(toas.get_flag_value("padd", 0.0, float))
    if not np.any(padd != 0.0):
        return None
    return torch.as_tensor(padd, dtype=torch.float64, device=device)


def tracked_phase(ph: Phase, pn=None, padd=None) -> torch.Tensor:
    """The residual phase [turns] of ``ph``: its fractional part, or its
    distance from the pulse numbers ``pn`` when given, plus the -padd
    adjustments ``padd`` when given. Maps under ``torch.func.vmap``."""
    full = ph.frac if pn is None else (ph.int - pn) + ph.frac
    return full if padd is None else full + padd


_WIDEBAND_REEXPORTS = ("WidebandTOAResiduals", "CombinedResiduals",
                       "DMResiduals")


def __getattr__(name):
    """The reference exposes the wideband residual classes from its
    residuals module too; they live in pint_tpu_torch.wideband (imported
    lazily here: a top-level import would be circular)."""
    if name in _WIDEBAND_REEXPORTS:
        from pint_tpu_torch import wideband

        return getattr(wideband, name)
    raise AttributeError(name)


def __dir__():
    return sorted(list(globals()) + list(_WIDEBAND_REEXPORTS))
