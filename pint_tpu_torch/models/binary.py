"""Binary pulsar models: ELL1/ELL1H/ELL1k, BT/BT_piecewise,
DD/DDS/DDH/DDGR/DDK (a port of pint_tpu/models/binary.py; reference:
src/pint/models/pulsar_binary.py and stand_alone_psr_binaries/).

Each model is one delay component of category ``pulsar_system``, last in
the delay chain: ``binary_delay`` is plain float64 torch on the TOAs'
device, and design columns come from ``torch.func.jacfwd`` through it,
as the reference takes them from ``jax.jacfwd``. Time since the orbital
epoch stays double-double until the orbit count has been reduced to a
phase in [-0.5, 0.5) turns, so sin/cos see O(1) arguments.

Formulas (SURVEY.md Appendix A.5):
- Kepler: E - e sin E = M by Newton's method, a fixed 10-step unroll
  from M + e sin M; jacfwd differentiates through the steps.
- DD (Damour-Deruelle 1986): alpha = x sin(omega), beta =
  x sqrt(1-etheta^2) cos(omega); Roemer + Einstein with the
  inverse-timing expansion; Shapiro -2 r ln(1 - e cosE -
  s [sin(omega)(cosE - e) + sqrt(1-e^2) cos(omega) sinE]).
- BT (Blandford-Teukolsky 1976): er = etheta = e, no Shapiro.
- ELL1 (Lange et al. 2001): Phi from TASC; Dre = x [sinPhi +
  (eps2/2) sin2Phi - (eps1/2) cos2Phi - (3/2) eps1]; Shapiro
  -2 r ln(1 - s sinPhi). ELL1H: orthometric H3/H4/STIG (Freire & Wex
  2010).

Orbits: PB/PBDOT or the FB0..FBn orbital-frequency series, selected by
FB0's presence.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from pint_tpu_torch.models.parameter import (
    MJDParameter,
    boolParameter,
    floatParameter,
    prefixParameter,
)
from pint_tpu_torch.models.timing_model import DelayComponent
from pint_tpu_torch.ops.dd import (
    DD,
    dd_add_f,
    dd_div_f,
    dd_frac,
    dd_mul_f,
    dd_sub,
    dd_sub_f,
    dd_to_f64,
    dd_where,
)
from pint_tpu_torch.ops.taylor import dd_taylor_horner, taylor_horner_deriv

__all__ = [
    "kepler_E", "PulsarBinary", "BinaryELL1", "BinaryELL1H", "BinaryELL1k",
    "BinaryBT", "BinaryBTPiecewise", "BinaryDD", "BinaryDDS", "BinaryDDH",
    "BinaryDDGR", "BinaryDDK",
]

SECS_PER_DAY = 86400.0
SECS_PER_YEAR = 365.25 * SECS_PER_DAY
DEG2RAD = np.pi / 180.0
TSUN = 4.925490947e-6  # GM_sun/c^3 [s]
TWOPI = 2.0 * np.pi


def _v(pv, name, default=0.0):
    """float64 value of a parameter (0-d tensor), or ``default`` when
    the model does not set it."""
    p = pv.get(name)
    return (p.hi + p.lo) if p is not None else default


class _RefDiv(torch.autograd.Function):
    """a / b whose forward-mode tangent is the reference's (JAX's)
    rule, da/b + (-db a) b^-2, where torch's is (da - db a/b)/b. The two
    round apart, which shows only where the tangent is a difference of
    nearly equal terms (DDK's x scaling, see BinaryDDK.binary_delay)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return a / b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, da, db):
        a, b = ctx.saved_tensors
        out = torch.zeros_like(a / b)
        if da is not None:
            out = out + da / b
        if db is not None:
            out = out + (-db * a) * (1.0 / (b * b))
        return out


def kepler_E(M, ecc, niter: int = 10):
    """Eccentric anomaly from mean anomaly: Newton's method, a fixed
    unroll of ``niter`` steps from M + e sin M (reference:
    binary_generic.py compute_eccentric_anomaly). No convergence test
    and no implicit derivative: jacfwd differentiates the steps."""
    E = M + ecc * torch.sin(M)
    for _ in range(niter):
        E = E - (E - ecc * torch.sin(E) - M) / (1.0 - ecc * torch.cos(E))
    return E


class PulsarBinary(DelayComponent):
    """Base binary component (reference: pulsar_binary.PulsarBinary).

    Subclasses define ``epoch_param`` (T0 or TASC) and
    ``binary_delay(pv, dt, M, nhat, ctx)``: dt is seconds since the
    orbital epoch, M the reduced mean anomaly/phase [rad], nhat = dM/dt
    [rad/s]."""

    category = "pulsar_system"
    register = False
    epoch_param = "T0"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("PB", units="d",
                                      description="orbital period"))
        self.add_param(floatParameter("PBDOT", units="s/s", value=0.0))
        self.add_param(floatParameter("A1", units="ls",
                                      description="projected semi-major axis"))
        self.add_param(floatParameter("A1DOT", units="ls/s", value=0.0,
                                      aliases=["XDOT"]))
        self.add_param(floatParameter("M2", units="Msun"))
        self.add_param(floatParameter("SINI", units=""))
        self.fb_terms: List[str] = []

    def add_fb_term(self, index, value=0.0, frozen=True):
        p = prefixParameter(prefix="FB", index=index,
                            index_str=str(index), value=value,
                            frozen=frozen, units=f"1/s^{index + 1}")
        self.add_param(p)
        self.setup()
        return p

    def setup(self):
        self.fb_terms = sorted(
            (n for n in self.params
             if n.startswith("FB") and n[2:].isdigit()),
            key=lambda n: int(n[2:]))
        # TEMPO convention: *DOT values > 1e-7 are in 1e-12 units
        for name in ("PBDOT", "A1DOT", "EDOT", "EPS1DOT", "EPS2DOT"):
            if name in self.params:
                p = self.params[name]
                if p.value is not None and abs(p.value) > 1e-7:
                    p.value = p.value * 1e-12
                    if p.uncertainty is not None:
                        p.uncertainty = p.uncertainty * 1e-12

    def validate(self):
        if self.params[self.epoch_param].value is None:
            raise ValueError(
                f"{type(self).__name__} requires {self.epoch_param}")
        if self.PB.value is None and not self.fb_terms:
            raise ValueError(
                f"{type(self).__name__} requires PB or FB0")

    def param_dimensions(self):
        from pint_tpu_torch.units import DIMENSIONLESS, parse_unit

        t = parse_unit("s")
        d = parse_unit("d")

        def fb_dim(name):
            return parse_unit("s") ** -(int(name[2:]) + 1)

        return {"PB": d, "PBDOT": DIMENSIONLESS, "A1": parse_unit("ls"),
                "A1DOT": parse_unit("ls/s"), "M2": parse_unit("Msun"),
                "SINI": DIMENSIONLESS, "T0": d, "TASC": d,
                "ECC": DIMENSIONLESS, "EDOT": t ** -1,
                "OM": parse_unit("deg"), "OMDOT": parse_unit("deg/yr"),
                "GAMMA": t, "EPS1": DIMENSIONLESS,
                "EPS2": DIMENSIONLESS, "EPS1DOT": t ** -1,
                "EPS2DOT": t ** -1, "FB*": fb_dim,
                "T0X_*": d, "A1X_*": parse_unit("ls"),
                "XR1_*": d, "XR2_*": d,
                "KIN": parse_unit("deg"), "KOM": parse_unit("deg"),
                "H3": t, "H4": t, "STIG": DIMENSIONLESS,
                "MTOT": parse_unit("Msun"), "XPBDOT": DIMENSIONLESS,
                "XOMDOT": parse_unit("deg/yr"),
                "DR": DIMENSIONLESS, "DTH": DIMENSIONLESS,
                "A0": t, "B0": t, "LNEDOT": t ** -1,
                "SHAPMAX": DIMENSIONLESS}

    # -- orbit machinery ----------------------------------------------

    def _epoch(self, pv, batch, cache):
        """Orbital epoch [MJD] as DD: a scalar, or per TOA for the
        piecewise model (BinaryBTPiecewise overrides)."""
        return pv[self.epoch_param]

    def _dt(self, pv, batch, cache, delay_so_far):
        """Barycentric seconds since the orbital epoch, as DD: a single
        float64 would lose the low bits of the orbit count."""
        ref = self._parent.ref_day
        tb = dd_mul_f(dd_add_f(batch.tdb_frac, batch.tdb_day - ref),
                      SECS_PER_DAY)
        epoch = self._epoch(pv, batch, cache)
        eref = dd_mul_f(dd_add_f(dd_sub_f(epoch, ref), 0.0), SECS_PER_DAY)
        return dd_sub_f(dd_sub(tb, eref), delay_so_far)

    def _mean_anomaly(self, dt_dd, pb_s, pbdot):
        """Reduced mean anomaly M in [-pi, pi] and nhat = dM/dt. The
        orbit count u = dt/PB (up to ~1e4) is formed in dd and reduced
        mod 1 turn before any trigonometry; every later use of M is
        periodic, so the reduction is exact algebra."""
        u_dd = dd_div_f(dt_dd, pb_s)
        u = dd_to_f64(u_dd)
        orbits = dd_sub_f(u_dd, 0.5 * pbdot * u * u)
        M = TWOPI * dd_to_f64(dd_frac(orbits))
        nhat = (TWOPI / pb_s) * (1.0 - pbdot * u)
        return M, nhat

    def _orbit(self, pv, dt_dd):
        """(M, nhat) [rad, rad/s] from DD dt: PB/PBDOT, or the FB
        series when FB0 is set."""
        if self.fb_terms:
            zero = torch.zeros_like(dt_dd.hi)
            coeffs = [DD(zero, zero)] + [pv[n] for n in self.fb_terms]
            orbits = dd_taylor_horner(dt_dd, coeffs)
            M = TWOPI * dd_to_f64(dd_frac(orbits))
            dt = dd_to_f64(dt_dd)
            plain = [torch.zeros((), dtype=dt.dtype, device=dt.device)] + \
                [_v(pv, n) for n in self.fb_terms]
            nhat = TWOPI * taylor_horner_deriv(dt, plain, 1)
            return M, nhat
        pb_s = _v(pv, "PB") * SECS_PER_DAY
        return self._mean_anomaly(dt_dd, pb_s, _v(pv, "PBDOT"))

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        dt_dd = self._dt(pv, batch, cache, delay_so_far)
        M, nhat = self._orbit(pv, dt_dd)
        return self.binary_delay(pv, dd_to_f64(dt_dd), M, nhat, ctx)

    def binary_delay(self, pv, dt, M, nhat, ctx):
        raise NotImplementedError

    # -- shared pieces -------------------------------------------------

    @staticmethod
    def _shapiro_rs(pv):
        """(r, s) from M2/SINI [s, 1]."""
        return TSUN * _v(pv, "M2"), _v(pv, "SINI")

    @staticmethod
    def _inverse_timing(Dre, Drep, Drepp, anhat, ecc_sinE_term):
        """The DD inverse-orbit-timing expansion (reference:
        DD_model.py delayR)."""
        nd = anhat * Drep
        return Dre * (1.0 - nd + nd * nd
                      + 0.5 * anhat * anhat * Dre * Drepp
                      - 0.5 * ecc_sinE_term * anhat * anhat * Dre * Drep)


class BinaryELL1(PulsarBinary):
    """Small-eccentricity model (reference: binary_ell1.BinaryELL1 /
    ELL1_model.ELL1model)."""

    register = True
    epoch_param = "TASC"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("TASC",
                                    description="ascending-node epoch"))
        self.add_param(floatParameter("EPS1", units="", value=0.0,
                                      description="e sin(omega)"))
        self.add_param(floatParameter("EPS2", units="", value=0.0,
                                      description="e cos(omega)"))
        self.add_param(floatParameter("EPS1DOT", units="1/s", value=0.0))
        self.add_param(floatParameter("EPS2DOT", units="1/s", value=0.0))

    def _roemer_eps(self, pv, dt, Phi, nhat, eps1, eps2):
        x = _v(pv, "A1") + _v(pv, "A1DOT") * dt
        sP, cP = torch.sin(Phi), torch.cos(Phi)
        s2P, c2P = torch.sin(2 * Phi), torch.cos(2 * Phi)
        # the constant -(3/2) eps1 term belongs to the O(e) expansion of
        # the Keplerian Roemer delay (Lange et al. 2001); without it
        # ELL1 and BT disagree by a constant 1.5 x e sin(omega)
        Dre = x * (sP + 0.5 * (eps2 * s2P - eps1 * c2P) - 1.5 * eps1)
        Drep = x * (cP + eps2 * c2P + eps1 * s2P)
        Drepp = x * (-sP - 2.0 * eps2 * s2P + 2.0 * eps1 * c2P)
        return self._inverse_timing(Dre, Drep, Drepp, nhat, 0.0)

    def _roemer(self, pv, dt, Phi, nhat):
        eps1 = _v(pv, "EPS1") + _v(pv, "EPS1DOT") * dt
        eps2 = _v(pv, "EPS2") + _v(pv, "EPS2DOT") * dt
        return self._roemer_eps(pv, dt, Phi, nhat, eps1, eps2)

    def _shapiro(self, pv, Phi):
        r, s = self._shapiro_rs(pv)
        return -2.0 * r * torch.log(1.0 - s * torch.sin(Phi))

    def binary_delay(self, pv, dt, M, nhat, ctx):
        return self._roemer(pv, dt, M, nhat) + self._shapiro(pv, M)


class BinaryELL1H(BinaryELL1):
    """ELL1 with orthometric Shapiro parameters H3/H4/STIG (reference:
    binary_ell1.BinaryELL1H / ELL1H_model; Freire & Wex 2010). With STIG
    (or H4, via STIG = H4/H3): r = H3/STIG^3, s = 2 STIG/(1+STIG^2);
    with H3 alone the third harmonic -(4/3) H3 sin(3 Phi)."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("M2")
        self.remove_param("SINI")
        self.add_param(floatParameter("H3", units="s",
                                      description="3rd Shapiro harmonic"))
        self.add_param(floatParameter("H4", units="s"))
        self.add_param(floatParameter("STIG", units="",
                                      aliases=["VARSIGMA"]))

    def validate(self):
        super().validate()
        if self.H3.value is None:
            raise ValueError("ELL1H requires H3")
        if self.H4.value is not None and self.STIG.value is not None:
            raise ValueError("give H4 or STIG, not both")

    def _shapiro(self, pv, Phi):
        h3 = _v(pv, "H3")
        if self.STIG.value is not None or self.H4.value is not None:
            stig = _v(pv, "STIG") if self.STIG.value is not None else \
                _v(pv, "H4") / h3
            r = h3 / (stig * stig * stig)
            s = 2.0 * stig / (1.0 + stig * stig)
            return -2.0 * r * torch.log(1.0 - s * torch.sin(Phi))
        return -(4.0 / 3.0) * h3 * torch.sin(3.0 * Phi)


class _KeplerBinary(PulsarBinary):
    """Shared eccentric-orbit parameters of BT and DD."""

    register = False

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("T0",
                                    description="periastron epoch"))
        self.add_param(floatParameter("ECC", units="", value=0.0,
                                      aliases=["E"]))
        self.add_param(floatParameter("EDOT", units="1/s", value=0.0))
        self.add_param(floatParameter("OM", units="deg", value=0.0))
        self.add_param(floatParameter("OMDOT", units="deg/yr", value=0.0))
        self.add_param(floatParameter("GAMMA", units="s", value=0.0))

    def _elements(self, pv, dt):
        """(x, ecc, omega [rad]) with secular drifts applied."""
        x = _v(pv, "A1") + _v(pv, "A1DOT") * dt
        ecc = _v(pv, "ECC") + _v(pv, "EDOT") * dt
        om = (_v(pv, "OM") + _v(pv, "OMDOT") * dt / SECS_PER_YEAR) \
            * DEG2RAD
        return x, ecc, om


class BinaryBT(_KeplerBinary):
    """Blandford-Teukolsky (reference: binary_bt.BinaryBT /
    BT_model.BTmodel): Keplerian Roemer + Einstein, no Shapiro."""

    register = True

    def _x_adjust(self, x, ctx):
        """Hook for per-TOA semi-major-axis changes
        (BinaryBTPiecewise overrides)."""
        return x

    def binary_delay(self, pv, dt, M, nhat, ctx):
        x, ecc, om = self._elements(pv, dt)
        x = self._x_adjust(x, ctx)
        E = kepler_E(M, ecc)
        sE, cE = torch.sin(E), torch.cos(E)
        alpha = x * torch.sin(om)
        beta = x * torch.sqrt(1.0 - ecc * ecc) * torch.cos(om)
        gamma = _v(pv, "GAMMA")
        Dre = alpha * (cE - ecc) + (beta + gamma) * sE
        Drep = -alpha * sE + (beta + gamma) * cE
        Drepp = -alpha * cE - (beta + gamma) * sE
        anhat = nhat / (1.0 - ecc * cE)
        return self._inverse_timing(
            Dre, Drep, Drepp, anhat, ecc * sE / (1.0 - ecc * cE))


class BinaryDD(_KeplerBinary):
    """Damour-Deruelle (reference: binary_dd.BinaryDD /
    DD_model.DDmodel)."""

    register = True

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("DR", units="", value=0.0))
        self.add_param(floatParameter("DTH", units="", value=0.0,
                                      aliases=["DTHETA"]))
        self.add_param(floatParameter("A0", units="s", value=0.0))
        self.add_param(floatParameter("B0", units="s", value=0.0))

    def _shapiro_s(self, pv):
        return _v(pv, "SINI")

    def _dd_core(self, pv, M, nhat, x, ecc, om, gamma, r_shap, s_shap,
                 dr, dth):
        """The DD delay for explicit orbital elements, shared by
        DD/DDS/DDH/DDGR/DDK, which differ only in how they obtain the
        elements and the Shapiro (r, s)."""
        er = ecc * (1.0 + dr)
        eth = ecc * (1.0 + dth)
        E = kepler_E(M, ecc)
        sE, cE = torch.sin(E), torch.cos(E)
        sw, cw = torch.sin(om), torch.cos(om)
        alpha = x * sw
        beta = x * torch.sqrt(1.0 - eth * eth) * cw
        # Roemer + Einstein with the inverse-timing correction
        Dre = alpha * (cE - er) + (beta + gamma) * sE
        Drep = -alpha * sE + (beta + gamma) * cE
        Drepp = -alpha * cE - (beta + gamma) * sE
        anhat = nhat / (1.0 - ecc * cE)
        roemer = self._inverse_timing(
            Dre, Drep, Drepp, anhat, ecc * sE / (1.0 - ecc * cE))
        # Shapiro
        sqr = torch.sqrt(1.0 - ecc * ecc)
        shap = -2.0 * r_shap * torch.log(
            1.0 - ecc * cE - s_shap * (sw * (cE - ecc) + sqr * cw * sE))
        # aberration (A0/B0, usually 0)
        a0, b0 = _v(pv, "A0"), _v(pv, "B0")
        nu = 2.0 * torch.atan2(
            torch.sqrt(1.0 + ecc) * torch.sin(E / 2.0),
            torch.sqrt(1.0 - ecc) * torch.cos(E / 2.0))
        omnu = om + nu
        aberr = a0 * (torch.sin(omnu) + ecc * sw) + \
            b0 * (torch.cos(omnu) + ecc * cw)
        return roemer + shap + aberr

    def binary_delay(self, pv, dt, M, nhat, ctx):
        x, ecc, om = self._elements(pv, dt)
        return self._dd_core(pv, M, nhat, x, ecc, om, _v(pv, "GAMMA"),
                             TSUN * _v(pv, "M2"), self._shapiro_s(pv),
                             _v(pv, "DR"), _v(pv, "DTH"))


class BinaryDDS(BinaryDD):
    """DD with s = 1 - exp(-SHAPMAX) (reference: binary_dd.BinaryDDS /
    DDS_model)."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.add_param(floatParameter("SHAPMAX", units="", value=0.0))

    def _shapiro_s(self, pv):
        return 1.0 - torch.exp(-_v(pv, "SHAPMAX"))


class BinaryDDH(BinaryDD):
    """DD with orthometric Shapiro parameters H3/STIG (reference:
    binary_dd.BinaryDDH / DDH_model; Freire & Wex 2010): r = H3/STIG^3,
    s = 2 STIG/(1 + STIG^2)."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("M2")
        self.remove_param("SINI")
        self.add_param(floatParameter("H3", units="s",
                                      description="3rd Shapiro harmonic"))
        self.add_param(floatParameter("STIG", units="",
                                      aliases=["VARSIGMA"]))

    def validate(self):
        super().validate()
        if self.H3.value is None or self.STIG.value is None:
            raise ValueError("DDH requires H3 and STIG")

    def binary_delay(self, pv, dt, M, nhat, ctx):
        x, ecc, om = self._elements(pv, dt)
        h3, stig = _v(pv, "H3"), _v(pv, "STIG")
        r = h3 / (stig * stig * stig)
        s = 2.0 * stig / (1.0 + stig * stig)
        return self._dd_core(pv, M, nhat, x, ecc, om, _v(pv, "GAMMA"),
                             r, s, _v(pv, "DR"), _v(pv, "DTH"))


class BinaryDDGR(BinaryDD):
    """DD with general relativity supplying the post-Keplerian
    parameters from the component masses (reference: binary_dd.BinaryDDGR
    / DDGR_model; Taylor & Weisberg 1989). MTOT and M2 replace OMDOT,
    GAMMA, SINI, PBDOT(GR), DR and DTH:

        n      = 2 pi / Pb,  m = MTOT Tsun,  m2 = M2 Tsun,  m1 = m-m2
        arr    = (m/n^2)^(1/3)
        omdot  = 3 n^(5/3) m^(2/3) / (1-e^2)          [rad/s]
        gamma  = e m2 (m1 + 2 m2) n^(-1/3) m^(-4/3)   [s]
        sini   = x m^(2/3) n^(2/3) / m2
        pbdot  = -(192 pi/5) n^(5/3) m1 m2 m^(-1/3)
                 (1 + 73/24 e^2 + 37/96 e^4)(1-e^2)^(-7/2)
        dr     = (3 m1^2 + 6 m1 m2 + 2 m2^2)/(arr m)
        dth    = (3.5 m1^2 + 6 m1 m2 + 2 m2^2)/(arr m)

    XOMDOT [deg/yr] and XPBDOT add observed excesses on top of GR."""

    register = True

    def __init__(self):
        super().__init__()
        for name in ("OMDOT", "GAMMA", "SINI", "DR", "DTH"):
            self.remove_param(name)
        self.add_param(floatParameter("MTOT", units="Msun",
                                      aliases=["M"]))
        self.add_param(floatParameter("XOMDOT", units="deg/yr",
                                      value=0.0))
        self.add_param(floatParameter("XPBDOT", units="s/s", value=0.0))

    def validate(self):
        super().validate()
        if self.MTOT.value is None or self.M2.value is None:
            raise ValueError("DDGR requires MTOT and M2")
        if self.PB.value is None:
            raise ValueError(
                "DDGR requires PB (the GR post-Keplerian expressions "
                "are not implemented for the FB series)")

    def _gr_parameters(self, pv, ecc):
        pb_s = _v(pv, "PB") * SECS_PER_DAY
        n = TWOPI / pb_s
        m = TSUN * _v(pv, "MTOT")
        m2 = TSUN * _v(pv, "M2")
        m1 = m - m2
        x = _v(pv, "A1")
        arr = (m / (n * n)) ** (1.0 / 3.0)
        omdot = 3.0 * n ** (5.0 / 3.0) * m ** (2.0 / 3.0) \
            / (1.0 - ecc * ecc)
        gamma = ecc * m2 * (m1 + 2.0 * m2) * n ** (-1.0 / 3.0) \
            * m ** (-4.0 / 3.0)
        sini = x * m ** (2.0 / 3.0) * n ** (2.0 / 3.0) / m2
        fe = (1.0 + (73.0 / 24.0) * ecc ** 2
              + (37.0 / 96.0) * ecc ** 4) * (1.0 - ecc * ecc) ** -3.5
        pbdot = -(192.0 * math.pi / 5.0) * n ** (5.0 / 3.0) * m1 * m2 \
            * m ** (-1.0 / 3.0) * fe
        dr = (3.0 * m1 ** 2 + 6.0 * m1 * m2 + 2.0 * m2 ** 2) / (arr * m)
        dth = (3.5 * m1 ** 2 + 6.0 * m1 * m2 + 2.0 * m2 ** 2) / (arr * m)
        return omdot, gamma, sini, pbdot, dr, dth

    def _orbit(self, pv, dt_dd):
        # the GR and excess PBDOT drive the mean-anomaly evolution
        ecc0 = _v(pv, "ECC")
        _, _, _, pbdot_gr, _, _ = self._gr_parameters(pv, ecc0)
        pb_s = _v(pv, "PB") * SECS_PER_DAY
        pbdot = _v(pv, "PBDOT") + pbdot_gr + _v(pv, "XPBDOT")
        return self._mean_anomaly(dt_dd, pb_s, pbdot)

    def binary_delay(self, pv, dt, M, nhat, ctx):
        ecc = _v(pv, "ECC") + _v(pv, "EDOT") * dt
        omdot_gr, gamma, sini, _, dr, dth = self._gr_parameters(pv, ecc)
        om = _v(pv, "OM") * DEG2RAD + omdot_gr * dt \
            + _v(pv, "XOMDOT") * DEG2RAD * dt / SECS_PER_YEAR
        x = _v(pv, "A1") + _v(pv, "A1DOT") * dt
        return self._dd_core(pv, M, nhat, x, ecc, om, gamma,
                             TSUN * _v(pv, "M2"), sini, dr, dth)


class BinaryDDK(BinaryDD):
    """DD with Kopeikin annual-orbital-parallax and proper-motion
    corrections (reference: binary_ddk.BinaryDDK / DDK_model; Kopeikin
    1995 ApJ 439 L5, Kopeikin 1996 ApJ 467 L93). KIN/KOM give the true
    orbital orientation; the observed x = a sin(i) and omega pick up

      K95 (annual-orbital parallax, needs PX and the observatory SSB
      position r): with the sky basis I0 (east) and J0 (north) and
      d = 1/PX,
        di    = (Delta_I0 sin KOM - Delta_J0 cos KOM)/d
        domega= -(Delta_I0 cos KOM + Delta_J0 sin KOM)/(d sin KIN)
      K96 (secular proper motion):
        di    += (-mu_alpha sin KOM + mu_delta cos KOM) (t - T0)
        domega+= (mu_alpha cos KOM + mu_delta sin KOM)/sin KIN (t - T0)

    x scales as sin(KIN + di)/sin(KIN); Shapiro s = sin(KIN + di). The
    sky basis is built on the TOAs' device from RAJ/DECJ, so DDK needs
    AstrometryEquatorial and PX."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("SINI")
        self.add_param(floatParameter("KIN", units="deg",
                                      description="orbital inclination"))
        self.add_param(floatParameter("KOM", units="deg",
                                      description="pos. angle of asc. node"))
        self.add_param(boolParameter("K96", value=True,
                                     description="include proper-motion "
                                     "corrections"))

    def validate(self):
        super().validate()
        if self.KIN.value is None or self.KOM.value is None:
            raise ValueError("DDK requires KIN and KOM")
        # RAJ/DECJ/PMRA/PMDEC/PX would be 0 in pv under ecliptic
        # astrometry: a silently wrong basis, so refuse
        parent = getattr(self, "_parent", None)
        if parent is not None:
            if "AstrometryEquatorial" not in parent.components:
                raise ValueError(
                    "DDK requires equatorial astrometry (RAJ/DECJ): "
                    "the Kopeikin terms are computed in that basis")
            px = parent.components["AstrometryEquatorial"].params.get(
                "PX")
            if px is None or px.value is None:
                raise ValueError(
                    "DDK requires PX (K95 terms scale as 1/distance)")

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        ctx["ssb_obs_pos"] = batch.ssb_obs_pos  # lt-s, for the K95 terms
        return super().delay(pv, batch, cache, ctx, delay_so_far)

    def binary_delay(self, pv, dt, M, nhat, ctx):
        from pint_tpu_torch.models.astrometry import MAS_TO_RAD, PC_LS

        x0, ecc, om = self._elements(pv, dt)
        kin = _v(pv, "KIN") * DEG2RAD
        kom = _v(pv, "KOM") * DEG2RAD
        skom, ckom = torch.sin(kom), torch.cos(kom)
        # sky basis at the (epoch) pulsar position
        a0 = _v(pv, "RAJ")
        d0 = _v(pv, "DECJ")
        sa, ca = torch.sin(a0), torch.cos(a0)
        sd, cd = torch.sin(d0), torch.cos(d0)
        I0 = torch.stack([-sa, ca, torch.zeros_like(ca)])
        J0 = torch.stack([-sd * ca, -sd * sa, cd])
        rvec = ctx.get("ssb_obs_pos")
        di = torch.zeros_like(dt)
        domega = torch.zeros_like(dt)
        px = _v(pv, "PX")
        if rvec is not None:
            d_ls = PC_LS * 1.0e3 / (px + 1e-30)  # PX [mas] -> d [lt-s]
            dI = rvec @ I0
            dJ = rvec @ J0
            di = di + (dI * skom - dJ * ckom) / d_ls
            domega = domega - (dI * ckom + dJ * skom) / (
                d_ls * torch.sin(kin))
        if self.K96.value:
            mu_a = _v(pv, "PMRA") * MAS_TO_RAD / SECS_PER_YEAR
            mu_d = _v(pv, "PMDEC") * MAS_TO_RAD / SECS_PER_YEAR
            di = di + (-mu_a * skom + mu_d * ckom) * dt
            domega = domega + (mu_a * ckom + mu_d * skom) \
                / torch.sin(kin) * dt
        kin_eff = kin + di
        # the KIN tangent of x is the difference of two ~x0 cot(KIN)
        # terms that cancel to ~x0 di: with torch's division tangent it
        # lands ~1e-11 of the design column away from the reference's
        x = _RefDiv.apply(x0 * torch.sin(kin_eff), torch.sin(kin))
        om = om + domega
        sini = torch.sin(kin_eff)
        return self._dd_core(pv, M, nhat, x, ecc, om, _v(pv, "GAMMA"),
                             TSUN * _v(pv, "M2"), sini,
                             _v(pv, "DR"), _v(pv, "DTH"))


class BinaryELL1k(BinaryELL1):
    """ELL1 for fast periastron advance (reference:
    binary_ell1.BinaryELL1k / ELL1k_model; Susobhanan et al. 2018):
    OMDOT rotates (EPS1, EPS2) exactly and LNEDOT scales the
    eccentricity, in place of the linear EPS1DOT/EPS2DOT drifts."""

    register = True

    def __init__(self):
        super().__init__()
        self.remove_param("EPS1DOT")
        self.remove_param("EPS2DOT")
        self.add_param(floatParameter("OMDOT", units="deg/yr",
                                      value=0.0))
        self.add_param(floatParameter("LNEDOT", units="1/s", value=0.0))

    def _roemer(self, pv, dt, Phi, nhat):
        eps1_0 = _v(pv, "EPS1")
        eps2_0 = _v(pv, "EPS2")
        omdot = _v(pv, "OMDOT") * DEG2RAD / SECS_PER_YEAR
        lnedot = _v(pv, "LNEDOT")
        dom = omdot * dt
        scale = 1.0 + lnedot * dt
        cdo, sdo = torch.cos(dom), torch.sin(dom)
        # rotate (eps2, eps1) = e(cos w, sin w) by dom, scale by e(t)/e0
        eps1 = scale * (eps1_0 * cdo + eps2_0 * sdo)
        eps2 = scale * (eps2_0 * cdo - eps1_0 * sdo)
        return self._roemer_eps(pv, dt, Phi, nhat, eps1, eps2)


class BinaryBTPiecewise(BinaryBT):
    """BT with piecewise-constant T0 and/or A1 over MJD ranges
    (reference: binary_bt.BinaryBTPiecewise / BT_piecewise.py, par name
    ``BT_piecewise``): within piece i's window [XR1_i, XR2_i), T0X_i and
    A1X_i replace the global T0/A1; outside every window the globals
    hold. Each piece is a 0/1 mask over the TOAs, built on the host from
    the TDB columns and moved to the device once by get_cache; the
    per-TOA epoch is a dd_where chain (it stays a dd pair per TOA) and
    the A1 swap rides the ``_x_adjust`` hook as a where chain."""

    register = True

    _KINDS = ("T0X_", "A1X_", "XR1_", "XR2_")

    def __init__(self):
        super().__init__()
        self.piece_ids: List[int] = []

    def add_piece_param(self, kind: str, index: int, index_str=None):
        name = f"{kind}{index_str or f'{index:04d}'}"
        if kind == "T0X_":
            # epochs keep the exact day/frac dd split a plain float
            # parse would round away (~0.3 us at MJD magnitudes)
            p = MJDParameter(name)
        else:
            units = {"A1X_": "ls", "XR1_": "MJD", "XR2_": "MJD"}[kind]
            p = prefixParameter(prefix=kind, index=index,
                                index_str=index_str or f"{index:04d}",
                                units=units)
        p.prefix, p.index = kind, index
        self.add_param(p)
        self.setup()
        return p

    def setup(self):
        super().setup()
        ids = set()
        names: dict = {}
        for n in self.params:
            for kind in self._KINDS:
                if n.startswith(kind) and n[len(kind):].isdigit():
                    i = int(n[len(kind):])
                    ids.add(i)
                    names.setdefault(i, {})[kind] = n
        self.piece_ids = sorted(ids)
        self._piece_names = names

    def validate(self):
        super().validate()
        for i in self.piece_ids:
            nm = self._piece_names[i]
            if "XR1_" not in nm or "XR2_" not in nm or \
                    self.params[nm["XR1_"]].value is None or \
                    self.params[nm["XR2_"]].value is None:
                raise ValueError(
                    f"BT_piecewise piece {i} needs XR1_/XR2_ bounds")
            if "T0X_" not in nm and "A1X_" not in nm:
                raise ValueError(
                    f"BT_piecewise piece {i} sets neither T0X nor A1X")
            if self.params[nm["XR1_"]].value >= \
                    self.params[nm["XR2_"]].value:
                raise ValueError(
                    f"BT_piecewise piece {i}: XR1 must be < XR2 "
                    f"(an inverted window would be silently inert)")
        # overlapping windows would double-apply in the where chains
        spans = sorted(
            (self.params[self._piece_names[i]["XR1_"]].value,
             self.params[self._piece_names[i]["XR2_"]].value)
            for i in self.piece_ids)
        for (a1, b1), (a2, _) in zip(spans, spans[1:]):
            if a2 < b1:
                raise ValueError("BT_piecewise windows overlap")

    def prepare(self, toas, cache, prefix=""):
        """One float64 0/1 mask per piece: TDB day + the dd fraction's
        high word inside [XR1, XR2), the reference's comparison."""
        mjd = np.asarray(toas.tdb_day) + np.asarray(toas.tdb_frac[0])
        for i in self.piece_ids:
            nm = self._piece_names[i]
            r1 = self.params[nm["XR1_"]].value
            r2 = self.params[nm["XR2_"]].value
            cache[f"btx_mask_{i}"] = (
                (mjd >= r1) & (mjd < r2)).astype(np.float64)

    def _epoch(self, pv, batch, cache):
        """Per-TOA orbital epoch: the global T0, T0X_i inside piece i's
        window."""
        shape = batch.tdb_day.shape
        t0 = pv["T0"]
        epoch = DD(torch.broadcast_to(t0.hi, shape),
                   torch.broadcast_to(t0.lo, shape))
        for i in self.piece_ids:
            t0n = self._piece_names[i].get("T0X_")
            if t0n is not None and t0n in pv:
                inside = cache[f"btx_mask_{i}"] > 0
                px = pv[t0n]
                epoch = dd_where(
                    inside,
                    DD(torch.broadcast_to(px.hi, shape),
                       torch.broadcast_to(px.lo, shape)), epoch)
        return epoch

    def delay(self, pv, batch, cache, ctx, delay_so_far):
        # the A1 swap rides ctx into _x_adjust; the epoch swap rides
        # _epoch inside the shared _dt
        a1_shift = torch.zeros_like(batch.freq_mhz)
        for i in self.piece_ids:
            a1n = self._piece_names[i].get("A1X_")
            if a1n is not None and a1n in pv:
                inside = cache[f"btx_mask_{i}"] > 0
                a1_shift = torch.where(
                    inside, _v(pv, a1n) - _v(pv, "A1"), a1_shift)
        ctx["btx_a1_shift"] = a1_shift
        return super().delay(pv, batch, cache, ctx, delay_so_far)

    def _x_adjust(self, x, ctx):
        return x + ctx.pop("btx_a1_shift", 0.0)
