"""Glitches, harmonic whitening (Wave, WaveX, DMWaveX), frequency-
dependent profile delays (FD) and the solar-wind dispersion (a port of
pint_tpu/models/components_extra.py; reference: src/pint/models/
glitch.py, wave.py, wavex.py, frequency_dependent.py and
solar_wind_dispersion.py).

An index family (the glitches, the WaveX and DMWaveX frequencies) is
evaluated as one (N, K) tensor op: its K parameters stacked into (K,)
tensors, one sin/cos or exp over (N, K), one reduction. The reference
loops over the indices in Python; the sums agree to rounding, not bit
for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import DMconst
from pint_tpu_torch.models.dispersion import per_nu2
from pint_tpu_torch.models.parameter import (
    MJDParameter,
    floatParameter,
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

SECS_PER_DAY = 86400.0
AU_M = 1.495978707e11
PC_M = 3.0856775814913673e16
C_M_S = 299792458.0


def _val(pv, name, default=0.0):
    p = pv.get(name)
    return (p.hi + p.lo) if p is not None else default


def stack_vals(pv, names, like):
    """(K,) tensor of the named parameters' values, hi + lo as _val reads
    them (0 for a name pv lacks): one stack for each word and one add,
    whatever K."""
    zero = None
    if any(n not in pv for n in names):
        zero = like.new_zeros(())
    hi = torch.stack([pv[n].hi if n in pv else zero for n in names])
    lo = torch.stack([pv[n].lo if n in pv else zero for n in names])
    return hi + lo


def tb_days(batch, ctx, ref):
    """Barycentric TDB days since the model's reference day, (N,) f64,
    kept in ctx for the other components of the pass."""
    tb = ctx.get("tb_days")
    if tb is None:
        tb = (batch.tdb_day - ref) + batch.tdb_frac.hi + batch.tdb_frac.lo
        ctx["tb_days"] = tb
    return tb


def fourier_columns(pv, t, freq_names):
    """(sin, cos), each (N, K): sin/cos(2 pi f_k t) for the family's
    frequencies [1/d] at t [d]."""
    w = (2.0 * math.pi) * stack_vals(pv, freq_names, t)
    arg = t[:, None] * w
    return torch.sin(arg), torch.cos(arg)


def safe_log_ghz(bf):
    """(finite mask, ln(nu/GHz) with 0 where nu is infinite). Infinite
    frequencies (barycentred TOAs) go through the log as 1 GHz, so
    neither the value nor a jacfwd tangent there is inf or NaN; the
    callers' ``where`` then zeroes those rows."""
    fin = torch.isfinite(bf)
    return fin, torch.log(torch.where(fin, bf, 1000.0) / 1000.0)


_GL_UNITS = {"GLEP_": "MJD", "GLPH_": "turn", "GLTD_": "d",
             "GLF0_": "Hz", "GLF1_": "Hz/s", "GLF2_": "Hz/s^2",
             "GLF0D_": "Hz"}


class Glitch(PhaseComponent):
    """Sudden spin-ups with exponential recovery (reference:
    glitch.Glitch). Per glitch n: GLEP_n (epoch), GLPH_n (phase step),
    GLF0_n/GLF1_n/GLF2_n (frequency-derivative steps), GLF0D_n + GLTD_n
    (a decaying frequency step, its timescale in days; GLTD 0 means no
    decay).

    phase(t >= GLEP) = GLPH + GLF0 dt + GLF1 dt^2/2 + GLF2 dt^3/6
                       + GLF0D tau (1 - exp(-dt/tau))
    """

    category = "glitch"
    register = True

    PREFIXES = ("GLEP_", "GLPH_", "GLF0_", "GLF1_", "GLF2_",
                "GLF0D_", "GLTD_")

    def __init__(self):
        super().__init__()
        # first-glitch templates: route GL*_n par keys here
        for pre in self.PREFIXES:
            self.add_param(prefixParameter(
                prefix=pre, index=1, index_str="1",
                units=_GL_UNITS[pre]))
        self.glitch_ids: list = []

    def add_glitch(self, index, epoch, ph=0.0, f0=0.0, f1=0.0, f2=0.0,
                   f0d=0.0, td=0.0, frozen=True):
        for pre, val in (("GLEP_", epoch), ("GLPH_", ph), ("GLF0_", f0),
                         ("GLF1_", f1), ("GLF2_", f2), ("GLF0D_", f0d),
                         ("GLTD_", td)):
            self.add_param(prefixParameter(
                prefix=pre, index=index, index_str=str(index), value=val,
                frozen=frozen if pre != "GLEP_" else True,
                units=_GL_UNITS[pre]))
        self.setup()

    def setup(self):
        ids = set()
        for name, p in self.params.items():
            for pre in self.PREFIXES:
                if name.startswith(pre) and p.value is not None:
                    ids.add(int(name[len(pre):]))
        self.glitch_ids = sorted(ids)
        # every glitch needs its epoch; missing sub-parameters are 0
        for i in self.glitch_ids:
            for pre in self.PREFIXES:
                nm = f"{pre}{i}"
                if nm not in self.params:
                    self.add_param(prefixParameter(
                        prefix=pre, index=i, index_str=str(i),
                        value=0.0, units=_GL_UNITS[pre]))
                elif self.params[nm].value is None and pre != "GLEP_":
                    self.params[nm].value = 0.0

    def validate(self):
        for i in self.glitch_ids:
            if self.params[f"GLEP_{i}"].value in (None, 0.0):
                raise ValueError(f"glitch {i} needs GLEP_{i}")

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {pre + "*": parse_unit(_GL_UNITS[pre])
                for pre in self.PREFIXES}

    def _terms(self, pv, tb_f):
        """{prefix: (K,) values}, dtc (N, K) (dt clipped at 0 before the
        epoch), on (N, K) and the recovery g = tau (1 - exp(-dt/tau))
        (0 where GLTD is 0)."""
        vals = {pre: stack_vals(pv, [f"{pre}{i}" for i in self.glitch_ids],
                                tb_f) for pre in self.PREFIXES}
        dt = tb_f[:, None] - (vals["GLEP_"] - self._parent.ref_day) \
            * SECS_PER_DAY
        on = dt >= 0.0
        dtc = torch.where(on, dt, 0.0)
        tau = vals["GLTD_"] * SECS_PER_DAY
        has_tau = tau > 0
        tau_safe = torch.where(has_tau, tau, 1.0)
        g = torch.where(has_tau, tau_safe * (1.0 - torch.exp(-dtc / tau_safe)),
                        0.0)
        return vals, dtc, on, g

    def phase(self, pv, batch, cache, ctx, tb):
        if not self.glitch_ids:
            z = torch.zeros_like(batch.freq_mhz)
            return DD(z, z)
        vals, dtc, on, g = self._terms(pv, tb.hi + tb.lo)
        ph = (vals["GLPH_"] + vals["GLF0_"] * dtc
              + vals["GLF1_"] * dtc * dtc / 2.0
              + vals["GLF2_"] * dtc ** 3 / 6.0
              + vals["GLF0D_"] * g)
        total = torch.sum(torch.where(on, ph, 0.0), dim=1)
        return DD(total, torch.zeros_like(total))

    _LD_PREFIXES = ("GLPH_", "GLF0_", "GLF1_", "GLF2_", "GLF0D_")

    def linear_design_names(self):
        # GLEP/GLTD enter nonlinearly and stay on AD when free; the
        # amplitudes are linear at the current epoch and timescale
        return [f"{pre}{i}" for i in self.glitch_ids
                for pre in self._LD_PREFIXES
                if not self.params[f"{pre}{i}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """Exact partials of the glitch phase in its amplitudes: on,
        on dt, on dt^2/2, on dt^3/6, on tau (1 - exp(-dt/tau))."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        tb = ctx["tb"]
        _, dtc, on, g = self._terms(pv, tb.hi + tb.lo)
        on = on.to(dtc.dtype)
        cols = {"GLPH_": on, "GLF0_": on * dtc,
                "GLF1_": on * dtc * dtc / 2.0, "GLF2_": on * dtc ** 3 / 6.0,
                "GLF0D_": on * g}
        return {f"{pre}{i}": ("phase", cols[pre][:, k])
                for k, i in enumerate(self.glitch_ids)
                for pre in self._LD_PREFIXES if f"{pre}{i}" in names}


class Wave(PhaseComponent):
    """TEMPO's sinusoid whitening (reference: wave.Wave): WAVE_OM
    [rad/day], WAVEEPOCH [MJD], WAVEn = (sin, cos) amplitude pairs [s].
    The summed time offset w(t) enters as phase -F0 w(t) (a positive
    offset is a later arrival, as for JUMP).

    The amplitudes are host data (a pairParameter is not a device
    parameter): w(t) is computed once per TOA set, and WaveX is the
    fittable harmonic model."""

    category = "wave"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("WAVE_OM", units="rad/d",
                                      aliases=["WAVEOM"]))
        self.add_param(MJDParameter("WAVEEPOCH"))
        self.add_param(pairParameter("WAVE1", units="s"))
        self.wave_ids: list = []

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("WAVE") and name[4:].isdigit():
                ids.append(int(name[4:]))
        self.wave_ids = sorted(ids)

    def validate(self):
        if self.wave_ids and self.WAVE_OM.value is None:
            raise ValueError("WAVE terms require WAVE_OM")

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"WAVE_OM": parse_unit("rad/d"),
                "WAVEEPOCH": parse_unit("d"),
                "WAVE*": parse_unit("s")}

    def prepare(self, toas, cache, prefix=""):
        if not self.wave_ids or self.WAVE_OM.value is None:
            return
        epoch = self.WAVEEPOCH.value
        if epoch is None:
            epoch = self._parent.PEPOCH.value
        t = toas.tdb_day + toas.tdb_frac[0] + toas.tdb_frac[1] - epoch
        om = self.WAVE_OM.value
        w = np.zeros(toas.ntoas)
        for k in self.wave_ids:
            a, b = self.params[f"WAVE{k}"].value
            w += a * np.sin(k * om * t) + b * np.cos(k * om * t)
        cache["wave_offset"] = w

    def phase(self, pv, batch, cache, ctx, tb):
        if "wave_offset" not in cache:
            z = torch.zeros_like(batch.freq_mhz)
            return DD(z, z)
        ph = -cache["wave_offset"] * _val(pv, "F0")
        return DD(ph, torch.zeros_like(ph))


class WaveX(DelayComponent):
    """Fourier delays at chosen frequencies (reference: wavex.WaveX):
    per index n, WXFREQ_000n [1/d], WXSIN_000n / WXCOS_000n [s];
    delay = sum WXSIN sin(2 pi f t) + WXCOS cos(2 pi f t), t from WXEPOCH
    (or PEPOCH). The frequencies are fixed, the amplitudes fittable."""

    category = "wavex"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("WXEPOCH"))
        self.add_param(prefixParameter(prefix="WXFREQ_", index=1,
                                       index_str="0001", units="1/d"))
        self.add_param(prefixParameter(prefix="WXSIN_", index=1,
                                       index_str="0001", units="s"))
        self.add_param(prefixParameter(prefix="WXCOS_", index=1,
                                       index_str="0001", units="s"))
        self.wavex_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"WXEPOCH": parse_unit("d"),
                "WXFREQ_*": parse_unit("1/d"),
                "WXSIN_*": parse_unit("s"),
                "WXCOS_*": parse_unit("s")}

    def add_wavex_component(self, freq_per_day, index=None, wxsin=0.0,
                            wxcos=0.0, frozen=False):
        # the next slot is one past the highest index in use, not the
        # count: with indices 0001 and 0003 the count would overwrite one
        if index is None:
            index = max((i for i, _ in self.wavex_ids), default=0) + 1
        istr = f"{index:04d}"
        for pre, val, frz in (("WXFREQ_", freq_per_day, True),
                              ("WXSIN_", wxsin, frozen),
                              ("WXCOS_", wxcos, frozen)):
            if f"{pre}{istr}" in self.params:
                p = self.params[f"{pre}{istr}"]
                p.value = val
                p.frozen = frz
            else:
                self.add_param(prefixParameter(
                    prefix=pre, index=index, index_str=istr, value=val,
                    frozen=frz,
                    units="1/d" if pre == "WXFREQ_" else "s"))
        self.setup()
        return index

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("WXFREQ_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.wavex_ids = sorted(ids)

    def validate(self):
        for idx, istr in self.wavex_ids:
            for pre in ("WXSIN_", "WXCOS_"):
                if f"{pre}{istr}" not in self.params:
                    raise ValueError(f"WXFREQ_{istr} missing {pre}{istr}")

    def _columns(self, pv, batch, ctx):
        ref = self._parent.ref_day
        epoch = frozen_value(self.WXEPOCH, self._parent.PEPOCH)
        t = tb_days(batch, ctx, ref) - (epoch - ref)
        return fourier_columns(pv, t, [f"WXFREQ_{s}"
                                       for _, s in self.wavex_ids])

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.wavex_ids:
            return torch.zeros_like(batch.freq_mhz)
        sin, cos = self._columns(pv, batch, ctx)
        like = batch.freq_mhz
        return sin @ stack_vals(pv, [f"WXSIN_{s}" for _, s in
                                     self.wavex_ids], like) \
            + cos @ stack_vals(pv, [f"WXCOS_{s}" for _, s in
                                    self.wavex_ids], like)

    def linear_design_names(self):
        return [f"{pre}{istr}" for _, istr in self.wavex_ids
                for pre in ("WXSIN_", "WXCOS_")
                if not self.params[f"{pre}{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(WXSIN/WXCOS) = sin/cos(2 pi f t) (exact at the
        current WXFREQ values)."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        cols = dict(zip(("WXSIN_", "WXCOS_"),
                        self._columns(pv, batch, {})))
        return {f"{pre}{istr}": ("pre_delay", cols[pre][:, k])
                for k, (_, istr) in enumerate(self.wavex_ids)
                for pre in ("WXSIN_", "WXCOS_") if f"{pre}{istr}" in names}


class DMWaveX(DelayComponent):
    """Fourier DM variations (reference: wavex.DMWaveX): DMWXFREQ_000n
    [1/d], DMWXSIN/DMWXCOS [pc/cm^3]; delay = DMconst DM(t) / nu^2."""

    category = "dispersion"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("DMWXEPOCH"))
        self.add_param(prefixParameter(prefix="DMWXFREQ_", index=1,
                                       index_str="0001", units="1/d"))
        self.add_param(prefixParameter(prefix="DMWXSIN_", index=1,
                                       index_str="0001",
                                       units="pc cm^-3"))
        self.add_param(prefixParameter(prefix="DMWXCOS_", index=1,
                                       index_str="0001",
                                       units="pc cm^-3"))
        self.dmwavex_ids: list = []

    def param_dimensions(self):
        from pint_tpu_torch.units import parse_unit

        return {"DMWXEPOCH": parse_unit("d"),
                "DMWXFREQ_*": parse_unit("1/d"),
                "DMWXSIN_*": parse_unit("pc cm^-3"),
                "DMWXCOS_*": parse_unit("pc cm^-3")}

    def add_dmwavex_component(self, freq_per_day, index=None,
                              dmwxsin=0.0, dmwxcos=0.0, frozen=False):
        """Fill or create one Fourier slot; the next index is one past
        the highest slot in use (as WaveX.add_wavex_component)."""
        if index is None:
            highest = [split_prefixed_name(nm)[2]
                       for nm in self.params
                       if nm.startswith("DMWXFREQ_")
                       and self.params[nm].value is not None]
            index = (max(highest) if highest else 0) + 1
        istr = f"{index:04d}"
        for pre, val, frz in (("DMWXFREQ_", freq_per_day, True),
                              ("DMWXSIN_", dmwxsin, frozen),
                              ("DMWXCOS_", dmwxcos, frozen)):
            name = f"{pre}{istr}"
            if name in self.params:
                p = self.params[name]
                p.value = val
                p.frozen = frz
            else:
                self.add_param(prefixParameter(
                    prefix=pre, index=index, index_str=istr, value=val,
                    frozen=frz, units=self.params[f"{pre}0001"].units))
        self.setup()
        return index

    def setup(self):
        ids = []
        for name in self.params:
            if name.startswith("DMWXFREQ_"):
                _, istr, idx = split_prefixed_name(name)
                if self.params[name].value is not None:
                    ids.append((idx, istr))
        self.dmwavex_ids = sorted(ids)

    def _columns(self, pv, batch, ctx):
        ref = self._parent.ref_day
        epoch = frozen_value(self.DMWXEPOCH, self._parent.PEPOCH)
        t = tb_days(batch, ctx, ref) - (epoch - ref)
        return fourier_columns(pv, t, [f"DMWXFREQ_{s}"
                                       for _, s in self.dmwavex_ids])

    def dm_value_device(self, pv, batch, cache, ctx):
        if not self.dmwavex_ids:
            return torch.zeros_like(batch.freq_mhz)
        sin, cos = self._columns(pv, batch, ctx)
        like = batch.freq_mhz
        return sin @ stack_vals(pv, [f"DMWXSIN_{s}" for _, s in
                                     self.dmwavex_ids], like) \
            + cos @ stack_vals(pv, [f"DMWXCOS_{s}" for _, s in
                                    self.dmwavex_ids], like)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        if not self.dmwavex_ids:
            return torch.zeros_like(batch.freq_mhz)
        return per_nu2(DMconst * self.dm_value_device(pv, batch, cache, ctx),
                       batch, ctx)

    def linear_design_names(self):
        return [f"{pre}{istr}" for _, istr in self.dmwavex_ids
                for pre in ("DMWXSIN_", "DMWXCOS_")
                if not self.params[f"{pre}{istr}"].frozen]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(DMWXSIN/COS) = DMconst sin/cos(arg) / nu^2."""
        names = set(self.linear_design_names())
        if not names:
            return {}
        sin, cos = self._columns(pv, batch, {})
        inv2 = per_nu2(DMconst, batch, ctx)[:, None]
        cols = {"DMWXSIN_": inv2 * sin, "DMWXCOS_": inv2 * cos}
        return {f"{pre}{istr}": ("pre_delay", cols[pre][:, k])
                for k, (_, istr) in enumerate(self.dmwavex_ids)
                for pre in ("DMWXSIN_", "DMWXCOS_")
                if f"{pre}{istr}" in names}


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


class SolarWindDispersion(DelayComponent):
    """Solar-wind dispersion (reference: solar_wind_dispersion.
    SolarWindDispersion). SWM 0: n_e(r) = NE_SW (1 AU/r)^2 integrated
    along the line of sight gives DM_sw = NE_SW AU^2 (pi - rho) /
    (r sin rho), rho the observer-frame angle between the Sun and the
    pulsar (rho -> 0 is the pulsar behind the Sun: the delay spikes at
    solar conjunction). SWM 1: n_e = NE_SW (AU/r)^SWP, the line-of-sight
    integral by a 64-node Gauss-Legendre rule, which jacfwd
    differentiates in the elongation and in a free SWP alike."""

    category = "solar_wind"
    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("NE_SW", units="cm^-3", value=0.0,
                                      aliases=["NE1AU", "SOLARN0"]))
        self.add_param(floatParameter("SWM", units="", value=0.0))
        self.add_param(floatParameter("SWP", units="", value=2.0,
                                      description="radial density "
                                      "power-law index (SWM 1)"))

    def param_dimensions(self):
        from pint_tpu_torch.units import DIMENSIONLESS, parse_unit

        return {"NE_SW": parse_unit("cm^-3"), "SWM": DIMENSIONLESS,
                "SWP": DIMENSIONLESS}

    def validate(self):
        if self.SWM.value not in (None, 0.0, 0, 1.0, 1):
            raise NotImplementedError("SWM must be 0 or 1")
        if int(self.SWM.value or 0) == 1 and \
                (self.SWP.value is None or self.SWP.value <= 1.0):
            raise ValueError("SWM 1 needs SWP > 1 (the line-of-sight "
                             "integral diverges otherwise)")

    _GL = np.polynomial.legendre.leggauss(64)

    def _gl_nodes(self, like):
        """The rule's (nodes, weights) on ``like``'s device, moved there
        once: a copy in every call would synchronize the stream."""
        key = (like.dtype, str(like.device))
        cached = self.__dict__.get("_gl_dev")
        if cached is None or cached[0] != key:
            cached = (key, tuple(torch.as_tensor(x, dtype=like.dtype,
                                                 device=like.device)
                                 for x in self._GL))
            self._gl_dev = cached
        return cached[1]

    def _cosq_integral(self, phi0, q):
        """int_{phi0}^{pi/2} cos^q(phi) dphi by the fixed rule; phi0 per
        TOA, q a 0-d tensor (> -1)."""
        nodes, wts = self._gl_nodes(phi0)
        half = (math.pi / 2 - phi0) / 2.0
        mid = (math.pi / 2 + phi0) / 2.0
        phi = mid[:, None] + half[:, None] * nodes[None, :]
        c = torch.clamp(torch.cos(phi), 1e-12, 1.0)
        return half * torch.sum(wts[None, :] * c ** q, dim=-1)

    def _geom(self, pv, batch, ctx):
        """The line-of-sight factor: dm = NE_SW * _geom (the NE_SW
        partial, shared by delay and linear_design_local)."""
        n = ctx["psr_dir"]  # (N, 3) unit observer->pulsar
        s = batch.obs_sun_pos  # (N, 3) observer->Sun, lt-s
        r_lts = torch.sqrt(torch.sum(s * s, dim=-1))
        cosr = torch.sum(s * n, dim=-1) / r_lts
        rho = torch.arccos(torch.clamp(cosr, -1.0, 1.0))
        r_m = r_lts * C_M_S
        sinr = torch.clamp(torch.sin(rho), min=1e-9)
        if int(frozen_value(self.SWM) or 0) == 1:
            # n_e = NE_SW (AU/r)^SWP: DM = NE_SW AU^p b^(1-p)
            #   int_{rho-pi/2}^{pi/2} cos^(p-2) dphi, b = r sin(rho)
            # (You et al. 2007); p = 2 is the SWM 0 closed form
            p = _val(pv, "SWP")
            b_m = r_m * sinr
            F = self._cosq_integral(rho - math.pi / 2.0, p - 2.0)
            return (AU_M / b_m) ** p * (b_m / PC_M) * F
        # SWM 0: DM [pc/cm^3] = NE_SW [cm^-3] AU^2 [m^2] / pc [m] * geom
        return (AU_M * AU_M / PC_M) * (math.pi - rho) / (r_m * sinr)

    def dm_value_device(self, pv, batch, cache, ctx):
        return _val(pv, "NE_SW") * self._geom(pv, batch, ctx)

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        return per_nu2(DMconst * self.dm_value_device(pv, batch, cache, ctx),
                       batch, ctx)

    def linear_design_names(self):
        return [] if self.NE_SW.frozen else ["NE_SW"]

    def linear_design_local(self, pv, batch, cache, ctx):
        """d(delay)/d(NE_SW) = DMconst geom / nu^2 (exact at the current
        SWP and astrometry; a free SWP stays on AD)."""
        if self.NE_SW.frozen:
            return {}
        return {"NE_SW": ("pre_delay",
                          per_nu2(DMconst * self._geom(pv, batch, ctx),
                                  batch, ctx))}
