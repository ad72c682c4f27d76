"""Phase jumps: per-TOA-subset constant offsets (JUMP mask parameters)
(a port of pint_tpu/models/jump.py; reference: src/pint/models/jump.py
PhaseJump). JUMP values are seconds; the phase contribution is −JUMP·F0
on the selected TOAs.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.timing_model import PhaseComponent
from pint_tpu_torch.ops.dd import DD


class PhaseJump(PhaseComponent):
    """Per-TOA-subset constant offsets: each JUMPn maskParameter is
    seconds on its selected TOAs."""

    category = "phase_jump"

    def __init__(self):
        super().__init__()
        self.jumps: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"JUMP*": parse_unit("s")}

    def setup(self):
        self.jumps = sorted(
            (n for n in self.params if n.startswith("JUMP")),
            key=lambda n: self.params[n].index)

    def prepare(self, toas, cache, prefix=""):
        for name in self.jumps:
            cache[f"mask_{name}"] = self.params[name].select_mask(
                toas).astype(np.float64)

    def phase(self, pv, batch, cache, ctx, tb):
        total = torch.zeros_like(batch.freq_mhz)
        f0 = pv["F0"].hi + pv["F0"].lo
        for name in self.jumps:
            total = total + (pv[name].hi + pv[name].lo) * \
                cache[f"mask_{name}"]
        ph = -total * f0
        return DD(ph, torch.zeros_like(ph))

    def linear_design_names(self):
        return [nm for nm in self.jumps if not self.params[nm].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(phase)/d(JUMPi) = -F0 * mask_i at the current F0."""
        f0 = pv["F0"].hi + pv["F0"].lo
        return {nm: ("phase", -f0 * cache[f"mask_{nm}"])
                for nm in self.jumps if not self.params[nm].frozen}
