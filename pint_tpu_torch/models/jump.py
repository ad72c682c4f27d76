"""Phase jumps: per-TOA-subset constant offsets (JUMP mask parameters)
(a port of pint_tpu/models/jump.py; reference: src/pint/models/jump.py
PhaseJump). JUMP values are seconds; the phase contribution is −JUMP·F0
on the selected TOAs.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.parameter import maskParameter
from pint_tpu_torch.models.timing_model import PhaseComponent
from pint_tpu_torch.ops.dd import DD


class PhaseJump(PhaseComponent):
    """Per-TOA-subset constant offsets (reference:
    src/pint/models/jump.py PhaseJump): each JUMPn maskParameter is
    seconds on its selected TOAs."""

    category = "phase_jump"

    def __init__(self):
        super().__init__()
        self.jumps: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"JUMP*": parse_unit("s")}

    def add_jump(self, index=None, key=None, key_value=(), value=0.0,
                 frozen=True, uncertainty=None):
        """A new JUMP mask parameter [s] selecting ``key key_value``; the
        index defaults to one past the highest in use. The parent model's
        TOA cache is dropped, so its next evaluation makes the new
        parameter's mask."""
        if index is None:
            index = max((self.params[n].index for n in self.jumps),
                        default=0) + 1
        p = maskParameter("JUMP", index=index, key=key,
                          key_value=key_value, value=value, frozen=frozen,
                          uncertainty=uncertainty, units="s")
        self.add_param(p)
        self.jumps.append(p.name)
        if self._parent is not None:
            self._parent.invalidate_cache()
        return p

    def tim_jumps_to_params(self, toas) -> list:
        """One free JUMP per distinct ``-tim_jump`` flag value on the
        TOAs (the flags the tim parser writes for JUMP blocks), skipping
        ids an existing -tim_jump JUMP covers (reference:
        PhaseJump.jump_flags_to_params). Returns the new parameters."""
        ids = sorted({f["tim_jump"] for f in toas.flags
                      if "tim_jump" in f}, key=str)
        covered = {p.key_value[0] for p in self.get_jump_param_objects()
                   if getattr(p, "key", None) == "-tim_jump"
                   and p.key_value}
        new = []
        for jid in ids:
            if str(jid) in covered:
                continue
            new.append(self.add_jump(key="-tim_jump",
                                     key_value=(str(jid),),
                                     value=0.0, frozen=False))
        if new:
            self.setup()
        return new

    def get_jump_param_objects(self):
        return [self.params[n] for n in self.jumps]

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
