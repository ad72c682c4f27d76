"""Explicit overall phase offset PHOFF (a port of
pint_tpu/models/phase_offset.py; reference:
src/pint/models/phase_offset.py PhaseOffset): residual phase gets −PHOFF
turns on every non-TZR row.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.parameter import floatParameter
from pint_tpu_torch.models.timing_model import PhaseComponent
from pint_tpu_torch.ops.dd import DD


class PhaseOffset(PhaseComponent):
    """Overall phase offset, left out of the TZR row (a constant in both
    would cancel out of the TZR-referenced phase)."""

    category = "phase_offset"
    apply_to_tzr = False

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("PHOFF", units="turn", value=0.0))

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"PHOFF": parse_unit("turn")}

    def phase(self, pv, batch, cache, ctx, tb):
        off = -(pv["PHOFF"].hi + pv["PHOFF"].lo)
        ph = off * torch.ones_like(batch.freq_mhz)
        return DD(ph, torch.zeros_like(ph))

    def linear_design_names(self):
        return [] if self.PHOFF.frozen else ["PHOFF"]

    def linear_design_local(self, pv, batch, cache, ctx):
        if self.PHOFF.frozen:
            return {}
        return {"PHOFF": ("phase", -torch.ones_like(batch.freq_mhz))}
