"""Derived astrophysical quantities from timing parameters (a copy of
pint_tpu/derived_quantities.py: host numpy).

Reference: src/pint/derived_quantities.py (mass_funct, mass_funct2,
companion_mass, pulsar_mass, pulsar_age, pulsar_edot, pulsar_B,
pulsar_B_lightcyl, omdot, gamma, pbdot, shklovskii_factor). All inputs
and outputs are plain floats in the conventional units noted per
function (no astropy in this stack); SI constants are exact IAU/CODATA
values.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mass_funct", "mass_funct2", "companion_mass", "pulsar_mass",
           "p_to_f", "f_to_p", "pulsar_age", "pulsar_edot", "pulsar_B",
           "pulsar_B_lightcyl", "omdot", "gamma", "pbdot", "pmtot",
           "shklovskii_factor"]

C = 299792458.0                  # m/s
TSUN = 4.925490947e-6            # GM_sun/c^3 [s]
GMSUN = TSUN * C ** 3            # m^3/s^2
MSUN_KG = 1.98892e30
SECPERDAY = 86400.0
SECPERYR = 86400.0 * 365.25
I_NS = 1e45 * 1e-7               # 10^45 g cm^2 -> kg m^2
PC_M = 3.0856775814913673e16
MAS_YR_TO_RAD_S = np.pi / 180.0 / 3600.0 / 1000.0 / SECPERYR


def p_to_f(p: float, pd: float = 0.0):
    """(F0, F1) from (P [s], Pdot) (reference: utils.p_to_f)."""
    f0 = 1.0 / p
    return f0, -pd / p ** 2


def f_to_p(f0: float, f1: float = 0.0):
    """(P [s], Pdot) from (F0, F1)."""
    p = 1.0 / f0
    return p, -f1 / f0 ** 2


def mass_funct(pb_days: float, x_lts: float) -> float:
    """Binary mass function [Msun]: 4 pi^2 x^3 / (G Pb^2)
    (reference: derived_quantities.mass_funct)."""
    pb = pb_days * SECPERDAY
    return 4.0 * np.pi ** 2 * x_lts ** 3 / (TSUN * pb ** 2)


def mass_funct2(mp: float, mc: float, i_deg: float) -> float:
    """(mc sin i)^3 / (mp + mc)^2 [Msun] (reference: mass_funct2)."""
    return (mc * np.sin(np.radians(i_deg))) ** 3 / (mp + mc) ** 2


def companion_mass(pb_days: float, x_lts: float, i_deg: float = 90.0,
                   mp: float = 1.4) -> float:
    """Companion mass [Msun] solving the mass function cubic
    (reference: companion_mass; exact real root of
    (mc sin i)^3 = f (mp+mc)^2)."""
    f = mass_funct(pb_days, x_lts)
    sini = np.sin(np.radians(i_deg))
    # solve s^3 mc^3 - f mc^2 - 2 f mp mc - f mp^2 = 0 (one real root)
    coeffs = [sini ** 3, -f, -2.0 * f * mp, -f * mp ** 2]
    roots = np.roots(coeffs)
    real = roots[np.abs(roots.imag) < 1e-9 * np.abs(roots.real + 1e-30)]
    return float(np.max(real.real))


def pulsar_mass(pb_days: float, x_lts: float, mc: float,
                i_deg: float) -> float:
    """Pulsar mass [Msun] given companion mass and inclination
    (reference: pulsar_mass)."""
    f = mass_funct(pb_days, x_lts)
    return float((mc * np.sin(np.radians(i_deg))) ** 1.5 / np.sqrt(f)
                 - mc)


def pulsar_age(f0: float, f1: float, n: int = 3) -> float:
    """Characteristic age [yr]: -f/((n-1) fdot) (reference:
    pulsar_age; n = braking index)."""
    return float(-f0 / ((n - 1) * f1) / SECPERYR)


def pulsar_edot(f0: float, f1: float, I: float = I_NS) -> float:
    """Spin-down luminosity [W]: -4 pi^2 I f fdot (reference:
    pulsar_edot)."""
    return float(-4.0 * np.pi ** 2 * I * f0 * f1)


def pulsar_B(f0: float, f1: float) -> float:
    """Surface dipole field [Gauss]: 3.2e19 sqrt(-pdot p)
    (reference: pulsar_B)."""
    p, pd = f_to_p(f0, f1)
    return float(3.2e19 * np.sqrt(-pd * p if pd < 0 else pd * p))


def pulsar_B_lightcyl(f0: float, f1: float) -> float:
    """Field at the light cylinder [Gauss] (reference:
    pulsar_B_lightcyl): 2.9e8 p^-5/2 sqrt(pdot)."""
    p, pd = f_to_p(f0, f1)
    return float(2.9e8 * abs(pd) ** 0.5 * p ** -2.5)


def omdot(mp: float, mc: float, pb_days: float, e: float) -> float:
    """GR periastron advance [deg/yr] (reference: omdot)."""
    n = 2.0 * np.pi / (pb_days * SECPERDAY)
    m = TSUN * (mp + mc)
    rate = 3.0 * n ** (5.0 / 3.0) * m ** (2.0 / 3.0) / (1.0 - e ** 2)
    return float(np.degrees(rate) * SECPERYR)


def gamma(mp: float, mc: float, pb_days: float, e: float) -> float:
    """GR Einstein-delay amplitude [s] (reference: gamma):
    e n^-1/3 m2 (m1 + 2 m2) M^-4/3, masses in time units."""
    n = 2.0 * np.pi / (pb_days * SECPERDAY)
    m1, m2 = TSUN * mp, TSUN * mc
    m = m1 + m2
    return float(e * n ** (-1.0 / 3.0) * m2 * (m1 + 2.0 * m2)
                 * m ** (-4.0 / 3.0))


def pbdot(mp: float, mc: float, pb_days: float, e: float) -> float:
    """GR orbital decay rate [s/s] (reference: pbdot)."""
    n = 2.0 * np.pi / (pb_days * SECPERDAY)
    m1, m2 = TSUN * mp, TSUN * mc
    m = m1 + m2
    fe = (1.0 + 73.0 / 24.0 * e ** 2 + 37.0 / 96.0 * e ** 4) \
        * (1.0 - e ** 2) ** -3.5
    return float(-(192.0 * np.pi / 5.0) * n ** (5.0 / 3.0) * m1 * m2
                 * m ** (-1.0 / 3.0) * fe)


def pmtot(model) -> float:
    """Total proper motion [mas/yr] from the model's astrometry
    (reference: derived_quantities.pmtot): quadrature sum of the
    equatorial (PMRA, PMDEC) or ecliptic (PMELONG, PMELAT) pair —
    both conventions carry the cos(latitude) factor already."""
    for a, b in (("PMRA", "PMDEC"), ("PMELONG", "PMELAT")):
        try:
            va = model.get_param(a).value
            vb = model.get_param(b).value
        except KeyError:
            continue
        return float(np.hypot(va or 0.0, vb or 0.0))
    raise ValueError("model has no proper-motion parameters")


def shklovskii_factor(pm_mas_yr: float, d_kpc: float) -> float:
    """Shklovskii apparent-acceleration factor a_s = mu^2 d / c [1/s]
    (multiply by P to get the apparent Pdot contribution; reference:
    shklovskii_factor)."""
    mu = pm_mas_yr * MAS_YR_TO_RAD_S
    return float(mu ** 2 * d_kpc * 1.0e3 * PC_M / C)
