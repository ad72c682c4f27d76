"""Astrometry: sky position + proper motion + parallax → Roemer delay
(a port of pint_tpu/models/astrometry.py; reference:
src/pint/models/astrometry.py AstrometryEquatorial, AstrometryEcliptic).

Delays here are ≤ ~500 s and need ns accuracy → plain f64 on the device;
only time and phase need dd. Angles are radians; proper motions mas/yr,
parallax mas (par-file units).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import c_m_s, pc_m
from pint_tpu_torch.models.parameter import (
    AngleParameter,
    MJDParameter,
    floatParameter,
    strParameter,
)
from pint_tpu_torch.models.timing_model import DelayComponent
from pint_tpu_torch.ops.dd import dd_to_f64
from pint_tpu_torch.time.frames import icrs_to_ecliptic_matrix

MAS_TO_RAD = np.pi / 180.0 / 3600.0 / 1000.0
PC_LS = pc_m / c_m_s  # parsec in light-seconds


class Astrometry(DelayComponent):
    category = "astrometry"
    register = False

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter(
            "POSEPOCH", description="epoch of position/proper motion"))
        self.add_param(floatParameter("PX", units="mas", value=0.0,
                                      description="parallax"))

    def _dt_yr(self, pv, batch):
        """Years since POSEPOCH (f64 — PM terms are tiny)."""
        pos_mjd = pv["POSEPOCH"].hi + pv["POSEPOCH"].lo \
            if "POSEPOCH" in pv else self._parent.ref_day
        tdb_mjd = batch.tdb_day + dd_to_f64(batch.tdb_frac)
        return (tdb_mjd - pos_mjd) / 365.25

    def psr_dir(self, pv, batch):
        """Unit vector SSB→pulsar, ICRS, per TOA (N,3)."""
        raise NotImplementedError

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        ang = parse_unit("rad")
        pm = parse_unit("mas/yr")
        return {"POSEPOCH": parse_unit("d"), "PX": parse_unit("mas"),
                "RAJ": ang, "DECJ": ang, "ELONG": ang, "ELAT": ang,
                "PMRA": pm, "PMDEC": pm, "PMELONG": pm, "PMELAT": pm}

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        n = self.psr_dir(pv, batch)
        ctx["psr_dir"] = n
        r = batch.ssb_obs_pos  # lt-s
        rdotn = torch.sum(r * n, dim=-1)
        # barycentric observing frequency for downstream dispersion; an
        # infinite frequency (barycentred TOAs, a TZR TOA without
        # TZRFRQ) stays infinite with a zero tangent, where the product
        # would make it inf * 0 = NaN
        vdotn = torch.sum(batch.ssb_obs_vel * n, dim=-1)  # v/c
        f = batch.freq_mhz
        ctx["bfreq"] = torch.where(torch.isfinite(f), f * (1.0 - vdotn), f)
        roemer = -rdotn
        if "PX" not in pv:
            return roemer
        px = pv["PX"].hi
        pxr = torch.where(px != 0.0, self._parallax_delay(r, rdotn, px),
                          torch.zeros_like(rdotn))
        return roemer + pxr

    def _parallax_delay(self, r, rdotn, px_mas):
        # Δ_px = (|r|² − (r·n̂)²) / (2 d)  [lt-s units] — reference:
        # Astrometry.solar_system_geometric_delay parallax term
        d_ls = PC_LS / (px_mas * 1e-3 + 1e-30)  # mas → arcsec → pc
        r2 = torch.sum(r * r, dim=-1)
        return (r2 - rdotn ** 2) / (2.0 * d_ls)


class AstrometryEquatorial(Astrometry):
    """RAJ/DECJ/PMRA/PMDEC (reference: AstrometryEquatorial)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(AngleParameter("RAJ", units="H:M:S",
                                      aliases=["RA"]))
        self.add_param(AngleParameter("DECJ", units="D:M:S",
                                      aliases=["DEC"]))
        self.add_param(floatParameter("PMRA", units="mas/yr", value=0.0,
                                      description="mu_alpha*cos(dec)"))
        self.add_param(floatParameter("PMDEC", units="mas/yr", value=0.0))

    def validate(self):
        if self.RAJ.value is None or self.DECJ.value is None:
            raise ValueError("AstrometryEquatorial requires RAJ and DECJ")

    def psr_dir(self, pv, batch):
        a0 = pv["RAJ"].hi + pv["RAJ"].lo
        d0 = pv["DECJ"].hi + pv["DECJ"].lo
        dt_yr = self._dt_yr(pv, batch)
        pmra = pv.get("PMRA")
        pmdec = pv.get("PMDEC")
        mu_a = (pmra.hi if pmra is not None else 0.0) * MAS_TO_RAD
        mu_d = (pmdec.hi if pmdec is not None else 0.0) * MAS_TO_RAD
        cosd = torch.cos(d0)
        # PMRA is mu_alpha* (includes cos dec): alpha advances by
        # mu_a dt / cos(dec)
        a = a0 + mu_a * dt_yr / cosd
        d = d0 + mu_d * dt_yr
        ca, sa = torch.cos(a), torch.sin(a)
        cd, sd = torch.cos(d), torch.sin(d)
        return torch.stack([cd * ca, cd * sa, sd], dim=-1)


class AstrometryEcliptic(Astrometry):
    """ELONG/ELAT/PMELONG/PMELAT in the IAU-obliquity ecliptic frame
    (reference: AstrometryEcliptic + pulsar_ecliptic.py)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(AngleParameter("ELONG", units="deg",
                                      aliases=["LAMBDA"]))
        self.add_param(AngleParameter("ELAT", units="deg",
                                      aliases=["BETA"]))
        self.add_param(floatParameter("PMELONG", units="mas/yr", value=0.0,
                                      aliases=["PMLAMBDA"]))
        self.add_param(floatParameter("PMELAT", units="mas/yr", value=0.0,
                                      aliases=["PMBETA"]))
        self.add_param(strParameter("ECL", value="IERS2010"))

    _OBLIQUITY = {  # arcsec (reference: src/pint/data/runtime/ecliptic.dat)
        "IERS2010": 84381.406,
        "IERS2003": 84381.4059,
        "IAU1976": 84381.448,
        "IAU1980": 84381.448,
    }

    @classmethod
    def obliquity_arcsec(cls, ecl) -> float:
        """Strict per-convention obliquity lookup."""
        obl = cls._OBLIQUITY.get((ecl or "IERS2010").upper())
        if obl is None:
            raise ValueError(
                f"unknown ecliptic convention {ecl!r} "
                f"(know {sorted(cls._OBLIQUITY)})")
        return obl

    def validate(self):
        if self.ELONG.value is None or self.ELAT.value is None:
            raise ValueError("AstrometryEcliptic requires ELONG and ELAT")
        self.obliquity_arcsec(self.ECL.value)  # typo'd ECL fails HERE

    def _ecl_matrix(self):
        obl = self.obliquity_arcsec(self.ECL.value)
        # ecliptic ← ICRS; we need its transpose to go ecliptic → ICRS
        return icrs_to_ecliptic_matrix(obl).T

    def psr_dir(self, pv, batch):
        l0 = pv["ELONG"].hi + pv["ELONG"].lo
        b0 = pv["ELAT"].hi + pv["ELAT"].lo
        dt_yr = self._dt_yr(pv, batch)
        mu_l = pv["PMELONG"].hi * MAS_TO_RAD if "PMELONG" in pv else 0.0
        mu_b = pv["PMELAT"].hi * MAS_TO_RAD if "PMELAT" in pv else 0.0
        cosb = torch.cos(b0)
        lam = l0 + mu_l * dt_yr / cosb
        bet = b0 + mu_b * dt_yr
        cl, sl = torch.cos(lam), torch.sin(lam)
        cb, sb = torch.cos(bet), torch.sin(bet)
        n_ecl = torch.stack([cb * cl, cb * sl, sb], dim=-1)
        # moved to the device once per obliquity and device: a copy in
        # every call would synchronize the stream
        key = (self.ECL.value, n_ecl.dtype, str(n_ecl.device))
        cached = getattr(self, "_ecl_dev", None)
        if cached is None or cached[0] != key:
            cached = (key, torch.as_tensor(
                np.ascontiguousarray(self._ecl_matrix()),  # graftlint: allow G2 -- a host constant (the obliquity rotation), uploaded once per obliquity and device and cached, never per call
                dtype=n_ecl.dtype, device=n_ecl.device))
            self._ecl_dev = cached
        return n_ecl @ cached[1].T
