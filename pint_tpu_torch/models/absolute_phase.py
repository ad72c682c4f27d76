"""Absolute phase anchor: TZRMJD/TZRSITE/TZRFRQ (a port of
pint_tpu/models/absolute_phase.py; reference:
src/pint/models/absolute_phase.py AbsPhase).

A one-TOA TOAs set at the TZR point defines phase zero; the TZR
mini-batch is built on the host in TimingModel._make_tzr_toas and the
subtraction happens in TimingModel.phase_fn, so this component's own
phase is identically zero.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.timing_model import PhaseComponent
from pint_tpu_torch.ops.dd import DD


class AbsPhase(PhaseComponent):
    """Absolute-phase anchor parameters (reference:
    src/pint/models/absolute_phase.py AbsPhase)."""

    category = "phase_offset"

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"TZRMJD": parse_unit("d"), "TZRFRQ": parse_unit("MHz")}

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter(
            "TZRMJD", description="zero-phase reference TOA"))
        self.add_param(strParameter("TZRSITE", value="ssb"))
        self.add_param(floatParameter("TZRFRQ", units="MHz", value=None,
                                      frozen=True))

    def validate(self):
        if self.TZRMJD.value is None:
            raise ValueError("AbsPhase requires TZRMJD")

    def phase(self, pv, batch, cache, ctx, tb):
        z = torch.zeros_like(batch.freq_mhz)
        return DD(z, z)
