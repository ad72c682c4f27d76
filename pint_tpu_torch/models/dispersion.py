"""Dispersion delay of the DM Taylor series (a port of DispersionDM in
pint_tpu/models/dispersion.py; reference:
src/pint/models/dispersion_model.py DispersionDM).

Delay = DMconst · DM(t) / ν² with ν the Doppler-corrected barycentric
frequency (ctx["bfreq"] from astrometry). DispersionDMX (piecewise DM
windows) and DispersionJump (DMJUMP, which moves only the wideband DM
channel) are here too. Every component's ``dm_value_device`` is its DM
contribution, which TimingModel.dm_total_device sums for the wideband
DM channel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
    maskParameter,
    prefixParameter,
    split_prefixed_name,
)
from pint_tpu_torch.models.timing_model import DelayComponent
from pint_tpu_torch.ops.dd import dd_to_f64
from pint_tpu_torch.ops.taylor import taylor_horner


def per_nu2(x, batch, ctx):
    """x / nu^2 with nu the barycentric frequency (ctx["bfreq"]), 0 where
    nu is infinite. Infinite rows divide by a stand-in 1 MHz, so neither
    the value nor a jacfwd tangent there is inf * 0; finite rows are
    x / (nu * nu) bit for bit. Every nu^-2 delay (DM, DMX, DMWaveX, the
    solar wind, SWX) and its closed-form column goes through it."""
    bf = ctx.get("bfreq", batch.freq_mhz)
    fin = torch.isfinite(bf)
    bs = torch.where(fin, bf, 1.0)
    return torch.where(fin, x / (bs * bs), 0.0)


class Dispersion(DelayComponent):
    category = "dispersion"
    register = False

    def dm_value_device(self, pv, batch, cache, ctx):
        """This component's DM contribution [pc/cm^3] (N,), the hook the
        wideband DM channel sums over (reference: TimingModel.total_dm
        summing Dispersion dm_value)."""
        return torch.zeros_like(batch.freq_mhz)

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        ne = parse_unit("pc cm^-3")

        def dm_dim(name):
            _, _, i = split_prefixed_name(name)
            return ne / parse_unit("yr") ** i

        return {"DM": ne, "DM*": dm_dim, "DMEPOCH": parse_unit("d"),
                "DMX": ne, "DMX_*": ne, "DMXR1_*": parse_unit("d"),
                "DMXR2_*": parse_unit("d"), "DMJUMP": ne}


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
                extras.append((int(name[2:]), name))  # graftlint: allow G1 -- name is a str (a parameter name parsed on the host)
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

    def dm_value_device(self, pv, batch, cache, ctx):
        return self.dm_value(pv, batch)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        dm = self.dm_value(pv, batch)
        ctx["dm"] = dm
        return per_nu2(DMconst * dm, batch, ctx)

    def linear_design_names(self):
        free = [nm for nm in self.dm_terms()
                if not self.params[nm].frozen]
        if free and not self.DMEPOCH.frozen:
            return []  # dt_yr pivots on a fitted DMEPOCH: stay on AD
        return free

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(DMk) = DMconst * dt_yr^k/k! / nu^2 (the Taylor
        factor mirrors dm_value's taylor_horner)."""
        names = self.linear_design_names()
        if not names:
            return {}
        inv2 = per_nu2(DMconst, batch, ctx)
        terms = self.dm_terms()
        if len(terms) > 1:
            dmep = pv["DMEPOCH"].hi + pv["DMEPOCH"].lo \
                if "DMEPOCH" in pv else self._parent.ref_day
            tdb = batch.tdb_day + dd_to_f64(batch.tdb_frac)
            dt_yr = (tdb - dmep) / 365.25
        out = {}
        for nm in names:
            k = terms.index(nm)
            if k == 0:
                out[nm] = ("pre_delay", inv2)
            else:
                out[nm] = ("pre_delay",
                           inv2 * dt_yr ** k / math.factorial(k))
        return out


class DispersionDMX(Dispersion):
    """Piecewise-constant ΔDM over MJD windows: DMX_0001/DMXR1_/DMXR2_
    (reference: DispersionDMX + TOASelect masks)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("DMX", units="pc cm^-3", value=0.0,
                                      description="legacy header value"))
        self.dmx_ids: list = []  # index ints, sorted at setup

    def add_dmx_range(self, index, mjd_start, mjd_end, value=0.0,
                      frozen=True, index_str=None):
        istr = index_str or f"{index:04d}"
        self.add_param(prefixParameter(prefix="DMX_", index=index,
                                       index_str=istr, value=value,
                                       units="pc cm^-3", frozen=frozen))
        self.add_param(prefixParameter(prefix="DMXR1_", index=index,
                                       index_str=istr, value=mjd_start,
                                       units="MJD"))
        self.add_param(prefixParameter(prefix="DMXR2_", index=index,
                                       index_str=istr, value=mjd_end,
                                       units="MJD"))

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("DMX_"):
                _, istr, idx = split_prefixed_name(name)
                ids.append((idx, istr))
        self.dmx_ids = sorted(ids)

    def validate(self):
        for idx, istr in self.dmx_ids:
            for pre in ("DMXR1_", "DMXR2_"):
                if f"{pre}{istr}" not in self.params:
                    raise ValueError(f"DMX_{istr} missing {pre}{istr}")

    def prepare(self, toas, cache, prefix=""):
        """(N, k) window mask matrix, host-precomputed (DMXR bounds are
        not fittable, as in the reference)."""
        if not self.dmx_ids:
            return
        mjd = toas.get_mjds()
        cols = []
        for idx, istr in self.dmx_ids:
            r1 = self.params[f"DMXR1_{istr}"].value
            r2 = self.params[f"DMXR2_{istr}"].value
            cols.append(((mjd >= r1) & (mjd <= r2)).astype(np.float64))
        cache["dmx_masks"] = np.stack(cols, axis=-1)

    def dm_value_device(self, pv, batch, cache, ctx):
        if not self.dmx_ids:
            return torch.zeros_like(batch.freq_mhz)
        vals = torch.stack(
            [pv[f"DMX_{istr}"].hi + pv[f"DMX_{istr}"].lo
             for _, istr in self.dmx_ids])
        return cache["dmx_masks"] @ vals

    def linear_design_names(self):
        return [f"DMX_{istr}" for _, istr in self.dmx_ids
                if not self.params[f"DMX_{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(DMX_i) = DMconst * window_mask_i / nu^2."""
        if not self.dmx_ids:
            return {}
        inv2 = per_nu2(DMconst, batch, ctx)
        masks = cache["dmx_masks"]
        out = {}
        for col, (_, istr) in enumerate(self.dmx_ids):
            nm = f"DMX_{istr}"
            if not self.params[nm].frozen:
                out[nm] = ("pre_delay", inv2 * masks[:, col])
        return out

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.dmx_ids:
            return torch.zeros_like(batch.freq_mhz)
        return per_nu2(
            DMconst * self.dm_value_device(pv, batch, cache, ctx), batch,
            ctx)


class DispersionJump(Dispersion):
    """DMJUMP: a constant DM offset per TOA subset that moves only the
    wideband DM measurements; its TOA delay is zero (reference:
    DispersionJump)."""

    register = True

    def __init__(self):
        super().__init__()
        self.dmjumps: list = []

    def add_dmjump(self, index, key, key_value, value=0.0, frozen=True):
        p = maskParameter("DMJUMP", index=index, key=key,
                          key_value=key_value, value=value, frozen=frozen,
                          units="pc cm^-3")
        self.add_param(p)
        self.dmjumps.append(p.name)
        return p

    def setup(self):
        self.dmjumps = [n for n in self.params if n.startswith("DMJUMP")]

    def prepare(self, toas, cache, prefix=""):
        for name in self.dmjumps:
            cache[f"mask_{name}"] = self.params[name].select_mask(
                toas).astype(np.float64)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        return torch.zeros_like(batch.freq_mhz)

    def dm_value_device(self, pv, batch, cache, ctx):
        """-Σ DMJUMPi·maski: the reference applies -DMJUMP to the model
        side of the selected subset (src/pint/models/dispersion_model.py
        DispersionJump.jump_dm), so a positive published DMJUMP means
        that the subset's measured DM reads low."""
        out = torch.zeros_like(batch.freq_mhz)
        for name in self.dmjumps:
            if name in pv:
                out = out - (pv[name].hi + pv[name].lo) * \
                    cache[f"mask_{name}"]
        return out
