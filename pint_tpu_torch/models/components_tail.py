"""The troposphere, chromatic variation (CM, CMX, CMWaveX), tabulated
phase (IFUNC), piecewise spindown, piecewise solar wind (SWX) and
per-system frequency-dependent jumps (FDJump) (a port of
pint_tpu/models/components_tail.py; reference: src/pint/models/
troposphere_delay.py, chromatic_model.py, wavex.py, ifunc.py,
piecewise.py, solar_wind_dispersion.py and fdjump.py).

Index families (CMX windows, CMWaveX frequencies, spindown pieces, SWX
windows) are one (N, K) tensor op each, as in components_extra.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.components_extra import (
    AU_M,
    C_M_S,
    PC_M,
    SECS_PER_DAY,
    _val,
    fourier_columns,
    safe_log_ghz,
    stack_vals,
    tb_days,
)
from pint_tpu_torch.models.dispersion import per_nu2
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    boolParameter,
    floatParameter,
    intParameter,
    maskParameter,
    pairParameter,
    prefixParameter,
    split_prefixed_name,
)
from pint_tpu_torch.models.timing_model import (
    DelayComponent,
    PhaseComponent,
    frozen_value,
)
from pint_tpu_torch.ops.dd import DD


def chromatic_index(parent, default: float = 4.0) -> float:
    """The model's chromatic index alpha (TNCHROMIDX on ChromaticCM),
    which ChromaticCMX, CMWaveX and PLChromNoise read as a host number.
    That is sound only while TNCHROMIDX is frozen: ChromaticCM reads it
    from pv and can fit it, the sharers cannot, so a free one raises the
    reference's ValueError."""
    if parent is not None and "ChromaticCM" in parent.components:
        p = parent.components["ChromaticCM"].TNCHROMIDX
        if not p.frozen:
            raise ValueError(
                "TNCHROMIDX is free, but ChromaticCMX/CMWaveX/"
                "PLChromNoise share it as a trace constant — fitting "
                "the chromatic index is only supported with "
                "ChromaticCM alone; freeze TNCHROMIDX")
        if p.value is not None:
            return float(p.value)
    return default


def chromatic_scale(batch, ctx, alpha):
    """Per-TOA chromatic factor DMconst nu^-alpha 1000^(alpha-2), 0 at
    an infinite frequency: the one place of the 1-GHz convention, behind
    the CM, CMX and CMWaveX delays and their closed-form columns."""
    bf = ctx.get("bfreq", batch.freq_mhz)
    fin = torch.isfinite(bf)
    out = DMconst * torch.where(fin, bf, 1000.0) ** -alpha \
        * (1000.0 ** (alpha - 2.0))
    return torch.where(fin, out, 0.0)


def _chromatic_delay(cm, batch, ctx, alpha):
    """DMconst cm nu^-alpha 1000^(alpha-2), 0 at an infinite frequency
    (CM referenced to 1 GHz: alpha = 2 is DM in the usual convention)."""
    bf = ctx.get("bfreq", batch.freq_mhz)
    out = DMconst * cm * bf ** -alpha * (1000.0 ** (alpha - 2.0))
    return torch.where(torch.isfinite(bf), out, 0.0)


def solar_wind_geometry_host(toas, psr_dir) -> np.ndarray:
    """The solar wind's line-of-sight DM factor on the host [pc/cm^3 per
    cm^-3 of NE_SW], (AU^2/pc)(pi - rho)/(r sin rho) with rho the
    Sun-pulsar elongation seen from the observatory (SWX and PLSWNoise;
    its device twin is SolarWindDispersion._geom). The TOAs' obs_sun_pos
    column is read as the reference reads it."""
    s = np.asarray(toas.obs_sun_pos)
    r_lts = np.linalg.norm(s, axis=-1)
    cosr = np.sum(s * psr_dir, axis=-1) / r_lts
    rho = np.arccos(np.clip(cosr, -1.0, 1.0))
    r_m = r_lts * C_M_S
    return (AU_M * AU_M / PC_M) * (np.pi - rho) / (
        r_m * np.maximum(np.sin(rho), 1e-9))


def _window_masks(toas, params, ids, lo, hi) -> np.ndarray:
    """(N, K) float64 masks of the MJD windows [lo_i, hi_i]."""
    mjd = toas.get_mjds()
    return np.stack([((mjd >= params[f"{lo}{istr}"].value)
                      & (mjd <= params[f"{hi}{istr}"].value))
                     .astype(np.float64) for _, istr in ids], axis=-1)


# --------------------------------------------------------- troposphere


class TroposphereDelay(DelayComponent):
    """Tropospheric delay: the zenith hydrostatic delay of a standard
    atmosphere at the site, mapped to the line of sight's elevation with
    the Niell (1996) mapping function (reference: troposphere_delay.
    TroposphereDelay).

    Host (prepare): the geocentric zenith unit vector in GCRS per TOA,
    the zenith delay, the site height, and the mapping coefficients
    a, b, c, interpolated in latitude on the 5-point grid and given
    their seasonal term; all of it is host data, so no tangent flows
    through it. Device: the elevation asin(zenith . psr_dir) and the
    mapping function, so the delay answers astrometry under jacfwd.
    CORRECT_TROPOSPHERE gates the component, as in the reference."""

    category = "troposphere"
    register = True

    # Niell 1996 hydrostatic mapping coefficients at |lat| = 15..75 deg
    _LAT_GRID = np.array([15.0, 30.0, 45.0, 60.0, 75.0])
    _H_AVG = np.array([
        [1.2769934e-3, 1.2683230e-3, 1.2465397e-3, 1.2196049e-3,
         1.2045996e-3],
        [2.9153695e-3, 2.9152299e-3, 2.9288445e-3, 2.9022565e-3,
         2.9024912e-3],
        [62.610505e-3, 62.837393e-3, 63.721774e-3, 63.824265e-3,
         64.258455e-3]])
    _H_AMP = np.array([
        [0.0, 1.2709626e-5, 2.6523662e-5, 3.4000452e-5, 4.1202191e-5],
        [0.0, 2.1414979e-5, 3.0160779e-5, 7.2562722e-5, 11.723375e-5],
        [0.0, 9.0128400e-5, 4.3497037e-5, 84.795348e-5, 170.37206e-5]])
    _H_HT = (2.53e-5, 5.49e-3, 1.14e-3)

    def __init__(self):
        super().__init__()
        self.add_param(boolParameter("CORRECT_TROPOSPHERE", value=True))

    def prepare(self, toas, cache, prefix=""):
        from pint_tpu_torch.observatory import get_observatory

        n = toas.ntoas
        zen = np.zeros((n, 3))
        mask = np.zeros(n)
        lat = np.zeros(n)
        zhd = np.zeros(n)  # zenith hydrostatic delay [s]
        h_km = np.zeros(n)
        utc = toas.get_mjds()
        tdb = toas.tdb_day + toas.tdb_frac[0] + toas.tdb_frac[1]
        for site in set(toas.obs):
            m = np.array([o == site for o in toas.obs])
            obs = get_observatory(site)
            xyz = getattr(obs, "itrf_xyz_m", None)
            if xyz is None:
                continue  # barycentre or geocentre: no troposphere
            p, _ = obs.gcrs_posvel(utc[m], tdb[m])
            zen[m] = p / np.linalg.norm(p, axis=-1, keepdims=True)
            mask[m] = 1.0
            glat = np.arctan2(xyz[2], np.hypot(xyz[0], xyz[1]))
            h_m = np.linalg.norm(xyz) - 6371000.0
            lat[m] = glat
            h_km[m] = max(h_m, 0.0) / 1000.0
            # standard atmosphere: P [hPa] at height; Davis et al. ZHD
            p_hpa = 1013.25 * (1.0 - 2.2557e-5 * h_m) ** 5.2568
            zhd_m = 0.0022768 * p_hpa / (
                1.0 - 0.00266 * np.cos(2.0 * glat) - 0.00028 * h_m / 1000.0)
            zhd[m] = zhd_m / C_M_S
        # the mapping coefficients: linear in |lat| on the grid (held at
        # its ends), the seasonal term from the day of the year (MJD 51544
        # is 2000-01-01), half a year later in the south
        abslat = np.abs(lat) * 180.0 / np.pi
        phase = 2.0 * np.pi * (np.mod(utc - 51544.0, 365.25) - 28.0) / 365.25
        cosph = np.cos(np.where(lat < 0, phase + np.pi, phase))
        for row, key in enumerate("abc"):
            cache[f"tropo_{key}"] = \
                np.interp(abslat, self._LAT_GRID, self._H_AVG[row]) \
                - np.interp(abslat, self._LAT_GRID, self._H_AMP[row]) * cosph
        cache["tropo_zen"] = zen
        cache["tropo_mask"] = mask
        cache["tropo_zhd"] = zhd
        cache["tropo_h_km"] = h_km

    @staticmethod
    def _nmf(sin_el, a, b, c):
        top = 1.0 + a / (1.0 + b / (1.0 + c))
        bot = sin_el + a / (sin_el + b / (sin_el + c))
        return top / bot

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.CORRECT_TROPOSPHERE.value:
            return torch.zeros_like(batch.freq_mhz)
        sin_el = torch.clamp(
            torch.sum(cache["tropo_zen"] * ctx["psr_dir"], dim=-1), 0.05,
            1.0)
        m_h = self._nmf(sin_el, cache["tropo_a"], cache["tropo_b"],
                        cache["tropo_c"])
        dm_ht = (1.0 / sin_el - self._nmf(sin_el, *self._H_HT)) \
            * cache["tropo_h_km"]
        return cache["tropo_mask"] * cache["tropo_zhd"] * (m_h + dm_ht)


# ----------------------------------------------------------- chromatic


class ChromaticCM(DelayComponent):
    """Chromatic delay (reference: chromatic_model.ChromaticCM): delay =
    DMconst CM(t) / nu^TNCHROMIDX, nu in MHz, CM a Taylor series (CM,
    CM1, ...) about CMEPOCH."""

    category = "chromatic"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("CM", units="pc cm^-3 MHz^(a-2)",
                                      value=0.0))
        self.add_param(prefixParameter(prefix="CM", index=1,
                                       index_str="1",
                                       units="pc cm^-3 MHz^(a-2)/s"))
        self.add_param(MJDParameter("CMEPOCH"))
        self.add_param(floatParameter("TNCHROMIDX", units="", value=4.0,
                                      aliases=["CMIDX"]))
        self.cm_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import DIMENSIONLESS, parse_unit

        # CM's unit depends on alpha (pc cm^-3 MHz^(alpha-2)), outside
        # the rational-exponent algebra: declared exempt (None)
        def cm_dim(name):
            return None

        return {"CM": cm_dim, "CM*": cm_dim,
                "CMEPOCH": parse_unit("d"),
                "TNCHROMIDX": DIMENSIONLESS}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("CM") and name[2:].isdigit() and \
                    self.params[name].value is not None:
                ids.append(int(name[2:]))
        self.cm_ids = sorted(ids)

    def _dt(self, batch, ctx):
        ref = self._parent.ref_day
        epoch = frozen_value(self.CMEPOCH, self._parent.PEPOCH)
        return (tb_days(batch, ctx, ref) - (epoch - ref)) * SECS_PER_DAY

    def cm_value_device(self, pv, batch, cache, ctx):
        dt = self._dt(batch, ctx)
        cm = _val(pv, "CM") * torch.ones_like(dt)
        for i in self.cm_ids:  # the true i! even where the series has gaps
            cm = cm + _val(pv, f"CM{i}") * dt ** i / math.factorial(i)
        return cm

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        return _chromatic_delay(self.cm_value_device(pv, batch, cache, ctx),
                                batch, ctx, _val(pv, "TNCHROMIDX", 4.0))

    def linear_design_names(self):
        out = [] if self.CM.frozen else ["CM"]
        out += [f"CM{i}" for i in self.cm_ids
                if not self.params[f"CM{i}"].frozen]
        if out and not self.CMEPOCH.frozen:
            return []  # dt pivots on a fitted CMEPOCH: stay on AD
        return out

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(CMk) = chromatic_scale dt^k/k! (TNCHROMIDX itself
        stays on AD when free)."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        sc = chromatic_scale(batch, ctx, _val(pv, "TNCHROMIDX", 4.0))
        out = {"CM": ("pre_delay", sc)} if "CM" in names else {}
        if any(nm != "CM" for nm in names):
            dt = self._dt(batch, {})
            for i in self.cm_ids:
                if f"CM{i}" in names:
                    out[f"CM{i}"] = ("pre_delay",
                                     sc * dt ** i / math.factorial(i))
        return out


class ChromaticCMX(DelayComponent):
    """Piecewise-constant chromatic variation over MJD windows:
    CMX_0001/CMXR1_0001/CMXR2_0001 (reference: chromatic_model.
    ChromaticCMX)."""

    category = "chromatic_cmx"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(prefixParameter(prefix="CMX_", index=1,
                                       index_str="0001",
                                       units="pc cm^-3 MHz^(a-2)"))
        self.add_param(prefixParameter(prefix="CMXR1_", index=1,
                                       index_str="0001", units="MJD"))
        self.add_param(prefixParameter(prefix="CMXR2_", index=1,
                                       index_str="0001", units="MJD"))
        self.cmx_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        # CMX_ shares CM's alpha-dependent unit: declared exempt
        return {"CMX_*": lambda name: None,
                "CMXR1_*": parse_unit("d"),
                "CMXR2_*": parse_unit("d")}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("CMX_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.cmx_ids = sorted(ids)

    def validate(self):
        for idx, istr in self.cmx_ids:
            for pre in ("CMXR1_", "CMXR2_"):
                if f"{pre}{istr}" not in self.params or \
                        self.params[f"{pre}{istr}"].value is None:
                    raise ValueError(f"CMX_{istr} missing {pre}{istr}")

    def prepare(self, toas, cache, prefix=""):
        if self.cmx_ids:
            cache["cmx_masks"] = _window_masks(toas, self.params,
                                               self.cmx_ids, "CMXR1_",
                                               "CMXR2_")

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.cmx_ids:
            return torch.zeros_like(batch.freq_mhz)
        vals = stack_vals(pv, [f"CMX_{s}" for _, s in self.cmx_ids],
                          batch.freq_mhz)
        return _chromatic_delay(cache["cmx_masks"] @ vals, batch, ctx,
                                chromatic_index(self._parent))

    def linear_design_names(self):
        return [f"CMX_{istr}" for _, istr in self.cmx_ids
                if not self.params[f"CMX_{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(CMX_i) = chromatic_scale window_mask_i."""
        if not self.cmx_ids:
            return {}
        sc = chromatic_scale(batch, ctx, chromatic_index(self._parent))
        cols = sc[:, None] * cache["cmx_masks"]
        return {f"CMX_{istr}": ("pre_delay", cols[:, k])
                for k, (_, istr) in enumerate(self.cmx_ids)
                if not self.params[f"CMX_{istr}"].frozen}


class CMWaveX(DelayComponent):
    """Fourier chromatic variations (reference: wavex.CMWaveX):
    CMWXFREQ_000n [1/d], CMWXSIN_/CMWXCOS_ [pc cm^-3 MHz^(a-2)]."""

    category = "cmwavex"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("CMWXEPOCH"))
        for pre in ("CMWXFREQ_", "CMWXSIN_", "CMWXCOS_"):
            self.add_param(prefixParameter(
                prefix=pre, index=1, index_str="0001",
                units="1/d" if pre == "CMWXFREQ_" else
                "pc cm^-3 MHz^(a-2)"))
        self.cmwx_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        # the amplitudes share CM's alpha-dependent unit: declared exempt
        return {"CMWXEPOCH": parse_unit("d"),
                "CMWXFREQ_*": parse_unit("1/d"),
                "CMWXSIN_*": lambda name: None,
                "CMWXCOS_*": lambda name: None}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("CMWXFREQ_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.cmwx_ids = sorted(ids)

    def _columns(self, pv, batch, ctx):
        ref = self._parent.ref_day
        epoch = frozen_value(self.CMWXEPOCH, self._parent.PEPOCH)
        t = tb_days(batch, ctx, ref) - (epoch - ref)
        return fourier_columns(pv, t, [f"CMWXFREQ_{s}"
                                       for _, s in self.cmwx_ids])

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.cmwx_ids:
            return torch.zeros_like(batch.freq_mhz)
        alpha = chromatic_index(self._parent)
        sin, cos = self._columns(pv, batch, ctx)
        like = batch.freq_mhz
        cm = sin @ stack_vals(pv, [f"CMWXSIN_{s}" for _, s in
                                   self.cmwx_ids], like) \
            + cos @ stack_vals(pv, [f"CMWXCOS_{s}" for _, s in
                                    self.cmwx_ids], like)
        return _chromatic_delay(cm, batch, ctx, alpha)

    def linear_design_names(self):
        return [f"{pre}{istr}" for _, istr in self.cmwx_ids
                for pre in ("CMWXSIN_", "CMWXCOS_")
                if not self.params[f"{pre}{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(CMWXSIN/COS) = chromatic_scale sin/cos(arg)."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        sc = chromatic_scale(batch, ctx,
                             chromatic_index(self._parent))[:, None]
        sin, cos = self._columns(pv, batch, {})
        cols = {"CMWXSIN_": sc * sin, "CMWXCOS_": sc * cos}
        return {f"{pre}{istr}": ("pre_delay", cols[pre][:, k])
                for k, (_, istr) in enumerate(self.cmwx_ids)
                for pre in ("CMWXSIN_", "CMWXCOS_")
                if f"{pre}{istr}" in names}


# ---------------------------------------------------- tabulated phase


class IFunc(PhaseComponent):
    """Tabulated phase offsets (reference: ifunc.IFunc): IFUNC<n> lines
    carry (MJD, seconds) pairs, SIFUNC the interpolation (2 linear, 0
    the nearest value); phase += F0 f(t). The table is host data (not
    fittable), as for its whitening use."""

    category = "ifunc"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(intParameter("SIFUNC", value=2))
        self.add_param(pairParameter("IFUNC1", units="MJD s"))
        self.ifunc_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"IFUNC*": parse_unit("MJD s")}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("IFUNC") and name[5:].isdigit():
                p = self.params[name]
                if p.value is not None and tuple(p.value) != (0.0, 0.0):
                    ids.append(int(name[5:]))
        self.ifunc_ids = sorted(ids)

    def validate(self):
        if self.SIFUNC.value not in (None, 0, 2):
            raise ValueError(
                f"SIFUNC {self.SIFUNC.value}: only 0 (constant) and "
                "2 (linear) are implemented (as in the reference)")

    def prepare(self, toas, cache, prefix=""):
        if not self.ifunc_ids:
            return
        pts = np.array([self.params[f"IFUNC{i}"].value
                        for i in self.ifunc_ids])
        order = np.argsort(pts[:, 0])
        t_k, v_k = pts[order, 0], pts[order, 1]
        mjd = toas.get_mjds()
        mode = self.SIFUNC.value
        mode = 2 if mode is None else int(mode)  # not `or`: 0 is valid
        if mode == 2:
            off = np.interp(mjd, t_k, v_k)
        else:  # mode 0: the nearest tabulated value
            off = v_k[np.abs(mjd[:, None] - t_k[None, :]).argmin(axis=1)]
        cache["ifunc_offset_s"] = off

    def phase(self, pv, batch, cache, ctx, tb):
        if not self.ifunc_ids:
            z = torch.zeros_like(batch.freq_mhz)
            return DD(z, z)
        ph = _val(pv, "F0") * cache["ifunc_offset_s"]
        return DD(ph, torch.zeros_like(ph))


# ------------------------------------------------- piecewise spindown


class PiecewiseSpindown(PhaseComponent):
    """Piecewise spin solutions over MJD ranges (reference: piecewise.
    PiecewiseSpindown): within [PWSTART_n, PWSTOP_n] the extra phase is
    PWPH_n + PWF0_n dt + PWF1_n dt^2/2 + PWF2_n dt^3/6, dt from PWEP_n."""

    category = "piecewise_spindown"
    register = True

    PREFIXES = ("PWEP_", "PWSTART_", "PWSTOP_", "PWPH_", "PWF0_",
                "PWF1_", "PWF2_")

    def __init__(self):
        super().__init__()
        for pre in self.PREFIXES:
            self.add_param(prefixParameter(
                prefix=pre, index=1, index_str="1",
                units={"PWEP_": "MJD", "PWSTART_": "MJD",
                       "PWSTOP_": "MJD", "PWPH_": "turn",
                       "PWF0_": "Hz", "PWF1_": "Hz/s",
                       "PWF2_": "Hz/s^2"}[pre]))
        self.pw_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        d, hz, s = (parse_unit("d"), parse_unit("Hz"),
                    parse_unit("s"))
        return {"PWEP_*": d, "PWSTART_*": d, "PWSTOP_*": d,
                "PWPH_*": parse_unit("turn"), "PWF0_*": hz,
                "PWF1_*": hz / s, "PWF2_*": hz / s ** 2}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("PWEP_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.pw_ids = sorted(ids)

    def validate(self):
        for idx, istr in self.pw_ids:
            for pre in ("PWSTART_", "PWSTOP_"):
                if self.params.get(f"{pre}{istr}") is None or \
                        self.params[f"{pre}{istr}"].value is None:
                    raise ValueError(f"PWEP_{istr} missing {pre}{istr}")

    def prepare(self, toas, cache, prefix=""):
        if self.pw_ids:
            cache["pw_masks"] = _window_masks(toas, self.params,
                                              self.pw_ids, "PWSTART_",
                                              "PWSTOP_")

    def _dt(self, pv, tb_f):
        """(N, K) seconds since each piece's PWEP_ epoch."""
        ep = stack_vals(pv, [f"PWEP_{s}" for _, s in self.pw_ids], tb_f)
        return tb_f[:, None] - (ep - self._parent.ref_day) * SECS_PER_DAY

    def phase(self, pv, batch, cache, ctx, tb):
        z = torch.zeros_like(batch.freq_mhz)
        if not self.pw_ids:
            return DD(z, z)
        tb_f = tb.hi + tb.lo
        dt = self._dt(pv, tb_f)
        v = {pre: stack_vals(pv, [f"{pre}{s}" for _, s in self.pw_ids], tb_f)
             for pre in self._LD_PW}
        ph = v["PWPH_"] + v["PWF0_"] * dt + v["PWF1_"] * dt * dt / 2.0 \
            + v["PWF2_"] * dt ** 3 / 6.0
        return DD(torch.sum(cache["pw_masks"] * ph, dim=1), z)

    _LD_PW = ("PWPH_", "PWF0_", "PWF1_", "PWF2_")

    def linear_design_names(self):
        # PWEP_ pivots the piece's dt: a piece with a fitted epoch keeps
        # all its parameters on AD
        out = []
        for idx, istr in self.pw_ids:
            if not self.params[f"PWEP_{istr}"].frozen:
                continue
            out += [f"{pre}{istr}" for pre in self._LD_PW
                    if f"{pre}{istr}" in self.params
                    and not self.params[f"{pre}{istr}"].frozen]
        return out

    def linear_design_local(self, pv, batch, cache, ctx):
        """Exact partials of the piecewise phase: mask, mask dt,
        mask dt^2/2, mask dt^3/6 per piece."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        tb = ctx["tb"]
        dt = self._dt(pv, tb.hi + tb.lo)
        m = cache["pw_masks"]
        cols = {"PWPH_": m, "PWF0_": m * dt, "PWF1_": m * dt * dt / 2.0,
                "PWF2_": m * dt ** 3 / 6.0}
        return {f"{pre}{istr}": ("phase", cols[pre][:, k])
                for k, (_, istr) in enumerate(self.pw_ids)
                for pre in self._LD_PW if f"{pre}{istr}" in names}


# ------------------------------------------------- piecewise solar wind


class SolarWindDispersionX(DelayComponent):
    """Piecewise solar-wind amplitude over MJD windows (reference:
    solar_wind_dispersion.SolarWindDispersionX): SWXDM_0001 with
    SWXR1_/SWXR2_ bounds. The per-TOA DM is SWXDM times the line-of-sight
    geometry normalized to its largest value in the window (SWXDM is the
    window's largest solar-wind DM); the geometry is host data at the
    catalogue position, whose change with fitted astrometry is second
    order."""

    category = "solar_windx"
    register = True

    def __init__(self):
        super().__init__()
        for pre, unit in (("SWXDM_", "pc cm^-3"), ("SWXR1_", "MJD"),
                          ("SWXR2_", "MJD")):
            self.add_param(prefixParameter(prefix=pre, index=1,
                                           index_str="0001", units=unit))
        self.swx_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"SWXDM_*": parse_unit("pc cm^-3"),
                "SWXR1_*": parse_unit("d"),
                "SWXR2_*": parse_unit("d")}

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("SWXDM_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.swx_ids = sorted(ids)

    def validate(self):
        for idx, istr in self.swx_ids:
            for pre in ("SWXR1_", "SWXR2_"):
                if self.params.get(f"{pre}{istr}") is None or \
                        self.params[f"{pre}{istr}"].value is None:
                    raise ValueError(f"SWXDM_{istr} missing {pre}{istr}")

    def prepare(self, toas, cache, prefix=""):
        if not self.swx_ids:
            return
        geom = solar_wind_geometry_host(toas,
                                        self._parent._host_psr_dir(toas))
        masks = _window_masks(toas, self.params, self.swx_ids, "SWXR1_",
                              "SWXR2_")
        cols = []
        for k in range(len(self.swx_ids)):
            m = masks[:, k] > 0
            gmax = geom[m].max() if np.any(m) else 1.0
            cols.append(np.where(m, geom / gmax, 0.0))
        cache["swx_cols"] = np.stack(cols, axis=-1)

    def dm_value_device(self, pv, batch, cache, ctx):
        """SWX's DM [pc/cm^3], also in the wideband DM channel. It reads
        no ctx (host geometry columns), so it adds no astrometry
        parameter to the DM-row Jacobian."""
        if not self.swx_ids:
            return torch.zeros_like(batch.freq_mhz)
        return cache["swx_cols"] @ stack_vals(
            pv, [f"SWXDM_{s}" for _, s in self.swx_ids], batch.freq_mhz)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.swx_ids:
            return torch.zeros_like(batch.freq_mhz)
        return per_nu2(DMconst * self.dm_value_device(pv, batch, cache, ctx),
                       batch, ctx)

    def linear_design_names(self):
        return [f"SWXDM_{istr}" for _, istr in self.swx_ids
                if not self.params[f"SWXDM_{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(SWXDM_i) = DMconst geom_col_i / nu^2."""
        if not self.swx_ids:
            return {}
        cols = per_nu2(DMconst, batch, ctx)[:, None] * cache["swx_cols"]
        return {f"SWXDM_{istr}": ("pre_delay", cols[:, k])
                for k, (_, istr) in enumerate(self.swx_ids)
                if not self.params[f"SWXDM_{istr}"].frozen}


# ----------------------------------------------------------- FD jumps


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
