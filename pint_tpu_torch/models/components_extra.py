"""Frequency-dependent profile-evolution delays, FD (a port of FD in
pint_tpu/models/components_extra.py; reference:
src/pint/models/frequency_dependent.py FD).

The reference module also holds glitches, Wave/WaveX/DMWaveX and the
solar wind; only FD is ported so far (ROADMAP.md).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.parameter import prefixParameter
from pint_tpu_torch.models.timing_model import DelayComponent


def _val(pv, name, default=0.0):
    p = pv.get(name)
    return (p.hi + p.lo) if p is not None else default


def safe_log_ghz(bf):
    """(finite mask, ln(nu/GHz) with 0 where nu is infinite). Infinite
    frequencies (barycentred TOAs) go through the log as 1 GHz, so
    neither the value nor a jacfwd tangent there is inf or NaN; the
    callers' ``where`` then zeroes those rows."""
    fin = torch.isfinite(bf)
    return fin, torch.log(torch.where(fin, bf, 1000.0) / 1000.0)


class FD(DelayComponent):
    """Frequency-dependent profile-evolution delay (reference:
    frequency_dependent.FD): delay = sum_i FDi ln(nu/1 GHz)^i."""

    category = "frequency_dependent"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(prefixParameter(prefix="FD", index=1,
                                       index_str="1", units="s"))
        self.fd_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"FD*": parse_unit("s")}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("FD") and name[2:].isdigit() and \
                    self.params[name].value is not None:
                ids.append(int(name[2:]))
        self.fd_ids = sorted(ids)

    def validate(self):
        # the Horner chain gives the exponent by position: indices must
        # be 1..n with no gaps (reference: FD.validate raises likewise)
        if self.fd_ids and self.fd_ids != list(
                range(1, len(self.fd_ids) + 1)):
            raise ValueError(
                f"FD indices must be sequential from 1, got {self.fd_ids}")

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.fd_ids:
            return torch.zeros_like(batch.freq_mhz)
        bf = ctx.get("bfreq", batch.freq_mhz)
        fin, logf = safe_log_ghz(bf)
        total = torch.zeros_like(bf)
        # Horner over ln(nu/GHz), i >= 1
        for i in reversed(self.fd_ids):
            total = (total + _val(pv, f"FD{i}")) * logf
        # TOAs at infinite frequency (barycentred data) see no FD delay
        return torch.where(fin, total, 0.0)

    def linear_design_names(self):
        return [f"FD{i}" for i in self.fd_ids
                if not self.params[f"FD{i}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(FDi) = ln(nu/GHz)^i (0 at infinite freq)."""
        fin, logf = safe_log_ghz(ctx.get("bfreq", batch.freq_mhz))
        return {f"FD{i}": ("pre_delay", torch.where(fin, logf ** i, 0.0))
                for i in self.fd_ids
                if not self.params[f"FD{i}"].frozen}
