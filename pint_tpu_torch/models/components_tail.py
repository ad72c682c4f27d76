"""Per-system frequency-dependent jumps, FDJump (a port of FDJump in
pint_tpu/models/components_tail.py; reference:
src/pint/models/fdjump.py FDJump).

The reference module also holds the troposphere, chromatic variation,
IFUNC, piecewise spindown and piecewise solar wind; only FDJump is
ported so far (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.components_extra import _val, safe_log_ghz
from pint_tpu_torch.models.parameter import maskParameter
from pint_tpu_torch.models.timing_model import DelayComponent


class FDJump(DelayComponent):
    """Per-system frequency-dependent delays (reference: fdjump.FDJump):
    ``FD1JUMP -fe Rcvr_800 1e-5 1`` applies FD-order-1 terms to the
    selected TOAs only; plain ``FDJUMP`` lines are order 1. delay =
    sum_jumps value * ln(nu/GHz)^order * mask."""

    category = "fdjump"
    register = True

    def __init__(self):
        super().__init__()
        self.fdjumps: list = []  # (order, param name)

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        # FD{n}JUMP{i} names do not fit the numeric-suffix star
        # convention: the materialized family is listed instead
        s = parse_unit("s")
        return {name: s for name in self.params if "JUMP" in name}

    def add_fdjump(self, order, key, key_value, value=0.0, frozen=True,
                   index=None):
        base = "FDJUMP" if order == 1 else f"FD{order}JUMP"
        idx = index or (sum(1 for o, _ in self.fdjumps if o == order)
                        + 1)
        p = maskParameter(base, index=idx, key=key, key_value=key_value,
                          value=value, frozen=frozen, units="s")
        self.add_param(p)
        self.setup()
        return p

    def setup(self):
        self.fdjumps = []
        for name in self.params:
            if name.startswith("FDJUMP"):
                self.fdjumps.append((1, name))
            elif name.startswith("FD") and "JUMP" in name:
                order = int(name[2:name.index("JUMP")])
                self.fdjumps.append((order, name))

    def prepare(self, toas, cache, prefix=""):
        for _, name in self.fdjumps:
            cache[f"mask_{name}"] = self.params[
                name].select_mask(toas).astype(np.float64)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        z = torch.zeros_like(batch.freq_mhz)
        if not self.fdjumps:
            return z
        fin, logf = safe_log_ghz(ctx.get("bfreq", batch.freq_mhz))
        total = z
        for order, name in self.fdjumps:
            if name in pv:
                total = total + _val(pv, name) * logf ** order * \
                    cache[f"mask_{name}"]
        return torch.where(fin, total, 0.0)

    def linear_design_names(self):
        return [name for _, name in self.fdjumps
                if not self.params[name].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(FDnJUMPi) = ln(nu/GHz)^n * mask_i."""
        if not self.fdjumps:
            return {}
        fin, logf = safe_log_ghz(ctx.get("bfreq", batch.freq_mhz))
        return {name: ("pre_delay", torch.where(
                    fin, logf ** order * cache[f"mask_{name}"], 0.0))
                for order, name in self.fdjumps
                if not self.params[name].frozen}
