"""Wideband fitting: joint [TOA; DM] GLS (a port of
pint_tpu/wideband_fitter.py; reference: src/pint/fitter.py
WidebandTOAFitter, WidebandDownhillFitter and
src/pint/pint_matrix.py combine_design_matrices_by_quantity).

Wideband TOAs carry a per-TOA DM measurement (-pp_dm/-pp_dme flags);
the fit minimizes the stacked residual

    [ r_time ]   [ M_time ]
    [ r_dm   ] - [ M_dm   ] dtheta   over  diag([s_toa^2; s_dm^2])

where M_time is the usual design matrix (d resid/d theta) and M_dm =
-d DM_model/d theta (r_dm = measured - model). Correlated-noise bases
act on the TOA rows; bases whose process is a DM perturbation
(PLDMNoise) also couple into the DM rows through
TimingModel.noise_model_dm_designmatrix, so one coefficient is seen
through both channels. The stack is a taller whitened least-squares
problem, solved by the GLS kernel unchanged, as float64 tensors on the
model's device.

Each stacked solve is one supervised dispatch of the whole pass (keys
``wideband.solve`` and ``wideband.svd``, GLSFitter's machinery); a
timed-out, broken or breaker-open device fails it over to the numpy
mirror on the same stacked system rebuilt on the CPU. Armed
($PINT_TPU_HEALTH), the stacked Cholesky solve returns its health
vector and is observed as ``wideband.solve`` (not shadowed).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pint_tpu_torch.gls import DownhillGLSFitter, GLSFitter, gls_chi2
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.wideband import DMResiduals, get_wideband_dm

__all__ = ["WidebandTOAFitter", "WidebandDownhillFitter",
           "build_dm_designmatrix"]


def build_dm_designmatrix(model, toas, names: List[str],
                          device=None) -> torch.Tensor:
    """(N, p) float64 tensor d DM_model/d theta_j on ``device`` (the
    model's by default) for the parameters ``names`` (column order
    matched; the 'Offset' column is 0: the phase offset does not move
    the DM channel). jacfwd of the same DM function the DM residuals use
    (TimingModel.build_dm_fn), so the two cannot disagree."""
    dm_fn, (free, th) = model.build_dm_fn(toas, device)
    jac = torch.func.jacfwd(dm_fn)(th)  # (N, p_free)
    out = jac.new_zeros((toas.ntoas, len(names)))
    for j, nm in enumerate(names):
        if nm != "Offset":
            out[:, j] = jac[:, free.index(nm)]
    return out


class WidebandTOAFitter(GLSFitter):
    """Joint TOA+DM GLS fit (reference: WidebandTOAFitter): GLSFitter's
    solve and loop over the stacked system of ``_system``, its Cholesky
    solve with the float32 Gram under $PINT_TPU_GLS_MATMUL (the
    reference's ``run_chol(f32mm)``) as GLSFitter's."""

    _KEY = "wideband"
    _WHAT = "wideband normal matrix"
    _SHADOW = None   # the reference shadows the time-only solve alone

    def __init__(self, toas, model, residuals=None, track_mode=None):
        get_wideband_dm(toas)  # validate the flags up front
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.dm_resids = DMResiduals(toas, model)
        self._noise_stack = None

    def _stacked_noise(self, device):
        """(nvec, F, phi) of the stacked system as float64 tensors on
        ``device``: the TOA then the scaled DM variances, and the
        time-channel noise basis over its DM-channel block. Made once
        per noise basis and device (the bases are static during a
        least-squares fit) and kept."""
        pairs = self.model.noise_model_basis_weight_pairs(self.toas)
        nvec = np.concatenate([
            self.model.scaled_toa_uncertainty(self.toas) ** 2,
            self.model.scaled_dm_uncertainty(self.toas) ** 2])
        cached = self._noise_stack
        if cached is not None and cached[0] is pairs and \
                cached[3] == str(device) and np.array_equal(cached[1], nvec):
            return cached[2]
        n = self.toas.ntoas
        F_t = self.model.noise_model_designmatrix(self.toas)
        phi = self.model.noise_model_basis_weight(self.toas)
        if F_t is None:
            F, phi = np.zeros((2 * n, 0)), np.ones(0)
        else:
            F = np.concatenate(
                [F_t, self.model.noise_model_dm_designmatrix(self.toas)],
                axis=0)
        out = tuple(torch.as_tensor(np.asarray(x, np.float64),
                                    device=device)
                    for x in (nvec, F, phi))
        self._noise_stack = (pairs, nvec, out, str(device))
        return out

    def _system(self, device=None):
        """The stacked [time; DM] problem at the current parameters, on
        ``device`` (the model's by default)."""
        dev = self.device if device is None else device
        res = self._residuals(dev)
        dm_res = DMResiduals(self.toas, self.model, device=dev)
        M_t, names, _ = self.model.designmatrix(self.toas, incoffset=True,
                                                device=dev)
        M_dm = -build_dm_designmatrix(self.model, self.toas, names, dev)
        r = torch.cat([res.time_resids, dm_res.resids])
        nvec, F, phi = self._stacked_noise(dev)
        return (torch.cat([M_t, M_dm]), r, nvec, F, phi, names,
                {"resids": res, "dm_resids": dm_res})

    @property
    def chi2_dm(self) -> float:
        return self.dm_resids.chi2

    def _dof(self) -> int:
        """chi2 sums over 2N stacked TOA+DM measurements (reference:
        _wb_dof)."""
        return 2 * self.toas.ntoas - len(self.model.free_params) - 1


class WidebandDownhillFitter(WidebandTOAFitter, DownhillGLSFitter):
    """Step-halving downhill wrapper over the wideband step (reference:
    WidebandDownhillFitter): DownhillGLSFitter's loop over the stacked
    system."""

    def _chi2_here(self) -> float:
        """The time channel's GLS chi2 plus the DM channel's white chi2,
        as the reference sums them."""
        r = Residuals(self.toas, self.model, track_mode=self.track_mode)
        return gls_chi2(self.model, self.toas, resids=r) + \
            DMResiduals(self.toas, self.model).chi2
