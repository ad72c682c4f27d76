"""Wideband TOA support: per-TOA DM measurements and joint residuals (a
port of pint_tpu/wideband.py; reference: src/pint/residuals.py
WidebandTOAResiduals, DMResiduals, CombinedResiduals and the
``-pp_dm``/``-pp_dme`` tim-file flags, which carry each wideband TOA's
measured DM and its uncertainty).

Residuals are float64 tensors on the model's device. The wideband
fitter (pint_tpu_torch.wideband_fitter) stacks [time residual; DM
residual] and the matching design rows, then solves with the GLS kernel
unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["get_wideband_dm", "has_wideband_dm", "DMResiduals",
           "CombinedResiduals", "WidebandTOAResiduals"]


def get_wideband_dm(toas) -> Tuple[np.ndarray, np.ndarray]:
    """(dm, dm_error) [pc/cm^3] from -pp_dm/-pp_dme flags; raises when
    any TOA lacks the DM channel (reference: TOAs.get_dms /
    WidebandTOAResiduals input contract)."""
    dm = toas.get_flag_value("pp_dm", as_type=float)
    dme = toas.get_flag_value("pp_dme", as_type=float)
    if any(v is None for v in dm):
        missing = sum(1 for v in dm if v is None)
        raise ValueError(
            f"{missing}/{toas.ntoas} TOAs lack -pp_dm wideband flags")
    if any(v is None for v in dme):
        missing = sum(1 for v in dme if v is None)
        raise ValueError(
            f"{missing}/{toas.ntoas} TOAs have -pp_dm but no -pp_dme "
            "uncertainty flag")
    return (np.array(dm, dtype=np.float64),
            np.array(dme, dtype=np.float64))


def has_wideband_dm(toas) -> bool:
    return all(v is not None
               for v in toas.get_flag_value("pp_dm"))


class DMResiduals:
    """DM-channel residuals: measured DM (flags) minus the model DM at
    each TOA (reference: residuals.DMResiduals), on ``device`` (the
    model's by default)."""

    def __init__(self, toas, model, subtract_mean: bool = False,
                 device=None):
        from pint_tpu_torch import resolve_device

        self.toas = toas
        self.model = model
        self.device = model.device if device is None \
            else resolve_device(device)
        self.subtract_mean = subtract_mean
        self._resids: Optional[torch.Tensor] = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64),
                               device=self.device)

    def model_dm(self) -> torch.Tensor:
        """Model DM at each TOA [pc/cm^3], summed over every component
        with a DM contribution (DM polynomial, DMX, DMJUMP with the
        reference's -DMJUMP model-side sign) by the one DM function
        (TimingModel.build_dm_fn)."""
        return self.model.total_dm(self.toas, self.device)

    def calc_resids(self) -> torch.Tensor:
        measured, _ = get_wideband_dm(self.toas)
        r = self._tensor(measured) - self.model_dm()
        if self.subtract_mean:
            w = 1.0 / self.dm_errors ** 2
            r = r - torch.sum(r * w) / torch.sum(w)
        return r

    @property
    def resids(self) -> torch.Tensor:
        if self._resids is None:
            self._resids = self.calc_resids()
        return self._resids

    @property
    def dm_errors(self) -> torch.Tensor:
        """Scaled (DMEFAC/DMEQUAD) DM uncertainties."""
        return self._tensor(self.model.scaled_dm_uncertainty(self.toas))

    @property
    def chi2(self) -> float:
        return float(torch.sum((self.resids / self.dm_errors) ** 2))


class CombinedResiduals:
    """Stack of heterogeneous residual channels with a combined chi2
    (reference: residuals.CombinedResiduals)."""

    def __init__(self, residual_objs):
        self.residual_objs = list(residual_objs)

    @property
    def chi2(self) -> float:
        return float(sum(r.chi2 for r in self.residual_objs))

    @property
    def resids(self) -> torch.Tensor:
        parts = []
        for r in self.residual_objs:
            v = getattr(r, "time_resids", None)
            parts.append(v if v is not None else r.resids)
        return torch.cat(parts)


class WidebandTOAResiduals(CombinedResiduals):
    """Joint TOA + DM residuals of a wideband data set (reference:
    residuals.WidebandTOAResiduals): .toa is the phase/time channel,
    .dm the DM-measurement channel."""

    def __init__(self, toas, model, subtract_mean=None,
                 track_mode=None):
        from pint_tpu_torch.residuals import Residuals

        self.toas = toas
        self.model = model
        self.toa = Residuals(toas, model, subtract_mean=subtract_mean,
                             track_mode=track_mode)
        self.dm = DMResiduals(toas, model)
        super().__init__([self.toa, self.dm])

    @property
    def dof(self) -> int:
        return 2 * self.toas.ntoas - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof
