"""Residuals: phase and time residuals, chi-square (a port of
pint_tpu/residuals.py; reference: src/pint/residuals.py
Residuals.calc_phase_resids, calc_time_resids, rms_weighted, chi2).

Phase arithmetic stays in double-double until the fractional part is
extracted; everything after (means, chi2) is float64 on the model's
device, so the residual vector never leaves it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device

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
            full = (ph.int - self._tensor(pn)) + ph.frac
        elif self.track_mode == "nearest":
            full = ph.frac
        else:
            raise ValueError(f"unknown track_mode {self.track_mode!r}")
        # per-TOA phase adjustments from tim-file PHASE commands (-padd)
        padd = np.array(self.toas.get_flag_value("padd", 0.0, float))
        if np.any(padd != 0.0):
            full = full + self._tensor(padd)
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

    @property
    def dof(self) -> int:
        return self.toas.ntoas - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof


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
