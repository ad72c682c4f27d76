"""Dispersion delay of the DM Taylor series (a port of DispersionDM in
pint_tpu/models/dispersion.py; reference:
src/pint/models/dispersion_model.py DispersionDM).

Delay = DMconst · DM(t) / ν² with ν the Doppler-corrected barycentric
frequency (ctx["bfreq"] from astrometry). DMX and DMJUMP are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    prefixParameter,
    split_prefixed_name,
)
from pint_tpu_torch.models.timing_model import DelayComponent
from pint_tpu_torch.ops.dd import dd_to_f64
from pint_tpu_torch.ops.taylor import taylor_horner


class Dispersion(DelayComponent):
    category = "dispersion"
    register = False

    def _bfreq(self, batch, ctx):
        return ctx.get("bfreq", batch.freq_mhz)

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        ne = parse_unit("pc cm^-3")

        def dm_dim(name):
            _, _, i = split_prefixed_name(name)
            return ne / parse_unit("yr") ** i

        return {"DM": ne, "DM*": dm_dim, "DMEPOCH": parse_unit("d")}


class DispersionDM(Dispersion):
    """DM + DM1·dt + DM2·dt²/2... around DMEPOCH (reference:
    DispersionDM)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("DM", units="pc cm^-3", value=0.0))
        self.add_param(floatParameter("DM1", units="pc cm^-3 / yr^1",
                                      value=None))
        self.add_param(MJDParameter("DMEPOCH"))

    def dm_terms(self):
        out = ["DM"]
        if self.DM1.value is not None:
            out.append("DM1")
        extras = []
        for name in self.params:
            if name.startswith("DM") and name not in (
                    "DM", "DM1", "DMEPOCH") and name[2:].isdigit():
                extras.append((int(name[2:]), name))
        out.extend(nm for _, nm in sorted(extras))
        return out

    def add_dm_term(self, index, value=0.0, frozen=True, uncertainty=None):
        p = prefixParameter(prefix="DM", index=index, value=value,
                            units=f"pc cm^-3 / yr^{index}", frozen=frozen,
                            uncertainty=uncertainty)
        self.add_param(p)
        return p

    def dm_value(self, pv, batch):
        """DM at each TOA [pc/cm3]; Taylor rates per year (par-file
        convention)."""
        terms = self.dm_terms()
        dm0 = pv["DM"].hi + pv["DM"].lo
        if len(terms) == 1:
            return dm0 * torch.ones_like(batch.freq_mhz)
        dmep = pv["DMEPOCH"].hi + pv["DMEPOCH"].lo if "DMEPOCH" in pv \
            else self._parent.ref_day
        tdb = batch.tdb_day + dd_to_f64(batch.tdb_frac)
        dt_yr = (tdb - dmep) / 365.25
        coeffs = [pv[nm].hi + pv[nm].lo for nm in terms]
        return taylor_horner(dt_yr, coeffs)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        bf = self._bfreq(batch, ctx)
        dm = self.dm_value(pv, batch)
        ctx["dm"] = dm
        return DMconst * dm / (bf * bf)
