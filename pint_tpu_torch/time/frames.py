"""Earth rotation and celestial frames — the ERFA replacement layer.

Replaces the PyERFA calls the reference makes through
src/pint/erfautils.py (gcrs_posvel_from_itrf: pnm06a/era00/sp00/pom00)
with an equinox-based chain:

    GCRS = P(t) · N(t) · R3(−GAST) · W · ITRF

- P: IAU-2006-compatible precession (Capitaine polynomials for ζ, z, θ);
- N: IAU2000B nutation, 31 leading lunisolar terms with t-dependent
  and out-of-phase coefficients + the fixed planetary bias (~1-2 mas
  worst-case vs the full 77-term table → ≲6 cm on the
  geocenter-to-site vector ≈ 0.2 ns of Roemer — error budget in
  ARCHITECTURE.md);
- GAST = GMST(ERA) + Δψ cos ε (equation of the equinoxes, leading term);
- W: polar motion, identity by default (no IERS tables offline; ~0.3″
  ≈ 9 m ≈ 30 ns — irrelevant for self-consistent fixtures, hook provided
  for real-data use);
- UT1 ≈ UTC (|ΔUT1| < 0.9 s ≈ ≤40 cm of site position; same hook).

All host-side numpy f64; angles in radians, times as TT/UT1 MJD f64
(sub-second argument errors are harmless here — rates are ≤ 7.3e-5 rad/s
and position enters delays divided by c).
"""

from __future__ import annotations

import numpy as np

ASEC2RAD = np.pi / (180.0 * 3600.0)
TURNAS = 1296000.0  # arcsec per turn
MJD_J2000 = 51544.5
OMEGA_EARTH = 2 * np.pi * 1.00273781191135448 / 86400.0  # rad/s (ERA rate)


def _jc(tt_mjd):
    """Julian centuries TT since J2000."""
    return (np.asarray(tt_mjd, np.float64) - MJD_J2000) / 36525.0


def earth_rotation_angle(ut1_mjd):
    """ERA(UT1), IAU 2000 (reference ERFA era00). Radians in [0, 2π)."""
    t = np.asarray(ut1_mjd, np.float64) - MJD_J2000
    # split t to keep the fast term accurate: ERA/2π = 0.779057… + t
    # + 0.00273781…·t (mod 1); the integer part of t drops out.
    era = 2 * np.pi * (
        (t % 1.0 + 0.7790572732640 + 0.00273781191135448 * t) % 1.0)
    return era % (2 * np.pi)


def gmst06(ut1_mjd, tt_mjd):
    """GMST consistent with IAU 2006 precession (reference ERFA gmst06):
    GMST = ERA + polynomial(t_TT)."""
    t = _jc(tt_mjd)
    poly = (0.014506 + 4612.156534 * t + 1.3915817 * t * t
            - 0.00000044 * t**3 - 0.000029956 * t**4) * ASEC2RAD
    return (earth_rotation_angle(ut1_mjd) + poly) % (2 * np.pi)


def obliquity06(tt_mjd):
    """Mean obliquity of the ecliptic, IAU 2006 (arcsec poly → rad)."""
    t = _jc(tt_mjd)
    eps = (84381.406 - 46.836769 * t - 0.0001831 * t * t
           + 0.00200340 * t**3)
    return eps * ASEC2RAD


# IAU 2000B lunisolar nutation, leading 31 terms of the published
# 77-term table (McCarthy & Luzum 2003): per row the Delaunay-argument
# multipliers (l, l', F, D, Om) and the coefficients
#   Δψ: ps·sin(arg) + pst·t·sin(arg) + pc·cos(arg)
#   Δε: ec·cos(arg) + ect·t·cos(arg) + es·sin(arg)
# in arcsec (pst/ect per Julian century). Terms 32-77 have amplitudes
# <0.8 mas each (omitted tail RSS ~1-2 mas ≈ <0.1 ns of Roemer on the
# site vector — error budget in ARCHITECTURE.md); the table is data,
# further extension stays mechanical.
_NUT_TERMS = np.array([
    # l  l'  F   D  Om     ps         pst        pc         ec         ect        es
    (0, 0, 0, 0, 1, -17.2064161, -0.0174666, 0.0033386, 9.2052331, 0.0009086, 0.0015377),
    (0, 0, 2, -2, 2, -1.3170906, -0.0001675, -0.0013696, 0.5730336, -0.0003015, -0.0004587),
    (0, 0, 2, 0, 2, -0.2276413, -0.0000234, 0.0002796, 0.0978459, -0.0000485, 0.0001374),
    (0, 0, 0, 0, 2, 0.2074554, 0.0000207, -0.0000698, -0.0897492, 0.0000470, -0.0000291),
    (0, 1, 0, 0, 0, 0.1475877, -0.0003633, 0.0011817, 0.0073871, -0.0000184, -0.0001924),
    (0, 1, 2, -2, 2, -0.0516821, 0.0001226, -0.0000524, 0.0224386, -0.0000677, -0.0000174),
    (1, 0, 0, 0, 0, 0.0711159, 0.0000073, -0.0000872, -0.0006750, 0.0, 0.0000358),
    (0, 0, 2, 0, 1, -0.0387298, -0.0000367, 0.0000380, 0.0200728, 0.0000018, 0.0000318),
    (1, 0, 2, 0, 2, -0.0301461, -0.0000036, 0.0000816, 0.0129025, -0.0000063, 0.0000367),
    (0, -1, 2, -2, 2, 0.0215829, -0.0000494, 0.0000111, -0.0095929, 0.0000299, 0.0000132),
    (0, 0, 2, -2, 1, 0.0128227, 0.0000137, 0.0000181, -0.0068982, -0.0000009, 0.0000039),
    (-1, 0, 2, 0, 2, 0.0123457, 0.0000011, 0.0000019, -0.0053311, 0.0000032, -0.0000004),
    (-1, 0, 0, 2, 0, 0.0156994, 0.0000010, -0.0000168, -0.0000127, 0.0, 0.0000082),
    (1, 0, 0, 0, 1, 0.0063110, 0.0000063, 0.0000027, -0.0033228, 0.0, -0.0000009),
    (-1, 0, 0, 0, 1, -0.0057976, -0.0000063, -0.0000189, 0.0031429, 0.0, -0.0000075),
    (-1, 0, 2, 2, 2, -0.0059641, -0.0000011, 0.0000149, 0.0025543, -0.0000011, 0.0000066),
    (1, 0, 2, 0, 1, -0.0051613, -0.0000042, 0.0000129, 0.0026366, 0.0, 0.0000078),
    (-2, 0, 2, 0, 1, 0.0045893, 0.0000050, 0.0000031, -0.0024236, -0.0000010, 0.0000020),
    (0, 0, 0, 2, 0, 0.0063384, 0.0000011, -0.0000150, -0.0001220, 0.0, 0.0000029),
    (0, 0, 2, 2, 2, -0.0038571, -0.0000001, 0.0000158, 0.0016452, -0.0000011, 0.0000068),
    (0, -2, 2, -2, 2, 0.0032481, 0.0, 0.0, -0.0013870, 0.0, 0.0),
    (-2, 0, 0, 2, 0, -0.0047722, 0.0, -0.0000018, 0.0000477, 0.0, -0.0000025),
    (2, 0, 2, 0, 2, -0.0031046, -0.0000001, 0.0000131, 0.0013238, -0.0000011, 0.0000059),
    (1, 0, 2, -2, 2, 0.0028593, 0.0, -0.0000001, -0.0012338, 0.0000010, -0.0000003),
    (-1, 0, 2, 0, 1, 0.0020441, 0.0000021, 0.0000010, -0.0010758, 0.0, -0.0000003),
    (2, 0, 0, 0, 0, 0.0029243, 0.0, -0.0000074, -0.0000609, 0.0, 0.0000013),
    (0, 0, 2, 0, 0, 0.0025887, 0.0, -0.0000066, -0.0000550, 0.0, 0.0000011),
    (0, 1, 0, 0, 1, -0.0014053, -0.0000025, 0.0000079, 0.0008551, -0.0000002, -0.0000045),
    (-1, 0, 0, 2, 1, 0.0015164, 0.0000010, 0.0000011, -0.0008001, 0.0, -0.0000001),
    (0, 2, 2, -2, 2, -0.0015794, 0.0000072, -0.0000016, 0.0006850, -0.0000042, -0.0000005),
    (0, 0, -2, 2, 0, 0.0021783, 0.0, 0.0000013, -0.0000167, 0.0, 0.0000013),
])

# IAU2000B fixed planetary-nutation bias (arcsec): the model's account
# of the planetary terms it omits relative to IAU2000A.
_NUT_PLANETARY_PSI = -0.000135
_NUT_PLANETARY_EPS = 0.000388


def _fundamental_args(t):
    """Delaunay arguments (rad); t in Julian centuries TT (IERS 2003)."""
    l = (134.96340251 + 477198.8675605 * t) * np.pi / 180.0   # noqa: E741
    lp = (357.52910918 + 35999.0502911 * t) * np.pi / 180.0
    F = (93.27209062 + 483202.0174577 * t) * np.pi / 180.0
    D = (297.85019547 + 445267.1114469 * t) * np.pi / 180.0
    Om = (125.04455501 - 1934.1362891 * t) * np.pi / 180.0
    return l, lp, F, D, Om


def nutation00b_truncated(tt_mjd):
    """(Δψ, Δε) in radians: 31-term IAU2000B lunisolar series with
    the t-dependent and out-of-phase coefficients, plus the model's
    fixed planetary bias. Truncation vs the full 77-term table is
    ~1-2 mas (see _NUT_TERMS comment); vs IAU2000A the 2000B model
    itself is ~1 mas 1995-2050."""
    t = _jc(tt_mjd)
    l, lp, F, D, Om = _fundamental_args(t)
    dpsi = np.full_like(t, _NUT_PLANETARY_PSI)
    deps = np.full_like(t, _NUT_PLANETARY_EPS)
    for cl, clp, cF, cD, cOm, ps, pst, pc, ec, ect, es in _NUT_TERMS:
        arg = cl * l + clp * lp + cF * F + cD * D + cOm * Om
        s, c = np.sin(arg), np.cos(arg)
        dpsi = dpsi + (ps + pst * t) * s + pc * c
        deps = deps + (ec + ect * t) * c + es * s
    return dpsi * ASEC2RAD, deps * ASEC2RAD


def _R1(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, c, s], -1),
        np.stack([z, -s, c], -1),
    ], -2)


def _R2(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, z, -s], -1),
        np.stack([z, o, z], -1),
        np.stack([s, z, c], -1),
    ], -2)


def _R3(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, z], -1),
        np.stack([-s, c, z], -1),
        np.stack([z, z, o], -1),
    ], -2)


def precession_matrix(tt_mjd):
    """Mean-of-J2000 ← mean-of-date rotation, Capitaine/IAU-2006-compatible
    equatorial precession angles ζ, z, θ:
        v_J2000 = R3(ζ) R2(−θ) R3(z) · v_date  (transpose of the classic
        date←J2000 matrix R3(−z) R2(θ) R3(−ζ)).
    """
    t = _jc(tt_mjd)
    zeta = (2.650545 + 2306.083227 * t + 0.2988499 * t**2
            + 0.01801828 * t**3) * ASEC2RAD
    z = (-2.650545 + 2306.077181 * t + 1.0927348 * t**2
         + 0.01826837 * t**3) * ASEC2RAD
    theta = (2004.191903 * t - 0.4294934 * t**2
             - 0.04182264 * t**3) * ASEC2RAD
    # date ← J2000 is R3(-z) R2(theta) R3(-zeta); we return its transpose
    m = _R3(-z) @ _R2(theta) @ _R3(-zeta)
    return np.swapaxes(m, -1, -2)


def nutation_matrix(tt_mjd):
    """Mean-of-date ← true-of-date: N^T = [R1(−ε−Δε) R3(−Δψ) R1(ε)]^T …
    returned as true→mean transpose so GCRS chain composes as P·N·R3(−GAST).
    """
    eps = obliquity06(tt_mjd)
    dpsi, deps = nutation00b_truncated(tt_mjd)
    n = _R1(-(eps + deps)) @ _R3(-dpsi) @ _R1(eps)  # true ← mean
    return np.swapaxes(n, -1, -2)  # mean ← true


def gast06(ut1_mjd, tt_mjd):
    eps = obliquity06(tt_mjd)
    dpsi, _ = nutation00b_truncated(tt_mjd)
    return (gmst06(ut1_mjd, tt_mjd) + dpsi * np.cos(eps)) % (2 * np.pi)


# ------------------------------------------------ EOP (IERS) hooks
# The reference gets dUT1/polar motion from downloaded IERS tables via
# astropy; offline they default to zero. set_eop installs a table (the
# same pluggable pattern as clock files): UT1 = UTC + interp(dut1), and
# polar motion rotates the ITRF vector before the Earth-rotation chain.

_EOP = None  # (mjd, dut1_s, xp_rad, yp_rad) arrays or None


def set_eop(mjd, dut1_s, xp_arcsec=None, yp_arcsec=None):
    """Install an Earth-orientation table (reference analog: the IERS-A
    table astropy downloads). Linear interpolation; outside the table
    range the edge values hold."""
    mjd = np.asarray(mjd, np.float64)
    global _EOP
    _EOP = (
        mjd,
        np.asarray(dut1_s, np.float64),
        np.asarray(xp_arcsec, np.float64) * ASEC2RAD
        if xp_arcsec is not None else np.zeros_like(mjd),
        np.asarray(yp_arcsec, np.float64) * ASEC2RAD
        if yp_arcsec is not None else np.zeros_like(mjd),
    )


def clear_eop():
    global _EOP
    _EOP = None


def _eop_at(utc_mjd):
    """(dut1_s, xp_rad, yp_rad) at the given UTC epochs."""
    if _EOP is None:
        z = np.zeros_like(np.asarray(utc_mjd, np.float64))
        return z, z, z
    mjd, dut1, xp, yp = _EOP
    u = np.asarray(utc_mjd, np.float64)
    return (np.interp(u, mjd, dut1), np.interp(u, mjd, xp),
            np.interp(u, mjd, yp))


def itrf_to_gcrs_posvel(itrf_xyz_m, utc_mjd, tt_mjd):
    """Observatory ITRF (x,y,z) [m] → GCRS position [m] and velocity [m/s]
    at the given epochs (reference: src/pint/erfautils.py
    gcrs_posvel_from_itrf). UT1 = UTC + dUT1 and polar motion from the
    installed EOP table (zero without one — ≤40 cm / ≤1.3 ns Roemer).

    itrf_xyz_m: (3,) site vector. utc/tt_mjd: (N,) epochs.
    Returns pos (N,3), vel (N,3).
    """
    itrf = np.asarray(itrf_xyz_m, np.float64)
    utc_mjd = np.atleast_1d(np.asarray(utc_mjd, np.float64))
    tt_mjd = np.atleast_1d(np.asarray(tt_mjd, np.float64))
    dut1, xp, yp = _eop_at(utc_mjd)
    ut1_mjd = utc_mjd + dut1 / 86400.0
    # compute the nutation series once — shared by GAST and the N matrix
    eps = obliquity06(tt_mjd)
    dpsi, deps = nutation00b_truncated(tt_mjd)
    gast = (gmst06(ut1_mjd, tt_mjd) + dpsi * np.cos(eps)) % (2 * np.pi)
    # true-of-date equatorial coords of the site
    cg, sg = np.cos(gast), np.sin(gast)
    x, y, z = itrf
    if _EOP is not None:
        # small-angle polar motion ITRS→TIRS, W ≈ R2(xp) R1(yp)
        # dropping the tiny s' term: r_TIRS = (x − xp z, y + yp z,
        # z + xp x − yp y)
        x, y, z = (x - xp * z,
                   y + yp * z,
                   z + xp * itrf[0] - yp * itrf[1])
    tod_pos = np.stack([cg * x - sg * y, sg * x + cg * y,
                        np.broadcast_to(z, cg.shape)], -1)
    # velocity: d/dt R3(−GAST) — Earth rotation dominates (precession
    # rates are ~1e-12 rad/s, negligible vs 7.3e-5)
    tod_vel = OMEGA_EARTH * np.stack(
        [-sg * x - cg * y, cg * x - sg * y, np.zeros_like(cg)], -1)
    n_true_from_mean = _R1(-(eps + deps)) @ _R3(-dpsi) @ _R1(eps)
    pn = precession_matrix(tt_mjd) @ np.swapaxes(n_true_from_mean, -1, -2)
    pos = np.einsum("...ij,...j->...i", pn, tod_pos)
    vel = np.einsum("...ij,...j->...i", pn, tod_vel)
    return pos, vel


def icrs_to_ecliptic_matrix(obliquity_arcsec: float = 84381.406):
    """Rotation ecliptic ← ICRS/equatorial (IERS2010 obliquity default;
    reference: src/pint/pulsar_ecliptic.py PulsarEcliptic + ecliptic.dat).
    """
    return _R1(np.float64(obliquity_arcsec * ASEC2RAD))
