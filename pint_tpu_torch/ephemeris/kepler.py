"""Analytic solar-system positions: Keplerian planetary elements (JPL
"Approximate Positions of the Planets", Standish, valid 1800–2050 AD) plus
a truncated lunar theory (Meeus-level leading terms) for the EMB→Earth
offset, and a mass-weighted Sun-wrt-SSB correction.

Accuracy, stated honestly: Earth wrt SSB good to ~1e-4 rad (~1.5e4 km,
~50 ms of Roemer delay) vs the real solar system. Everything downstream
is *internally consistent* — the simulate→fit oracle, derivative checks,
and benchmarks are unaffected; real-data work needs an SPK kernel
(pint_tpu_torch.ephemeris.spk).

All outputs: ICRS-equatorial-ish J2000 frame, meters and m/s, wrt SSB.
(reference: src/pint/solar_system_ephemerides.py objPosVel_wrt_SSB)
"""

from __future__ import annotations

import numpy as np

AU = 1.495978707e11  # m
DAY = 86400.0
MJD_J2000 = 51544.5
EPS0 = 84381.406 * np.pi / (180 * 3600)  # J2000 mean obliquity (rad)

# (a [au], a_dot/cy, e, e_dot, I [deg], I_dot, L [deg], L_dot,
#  varpi [deg], varpi_dot, Omega [deg], Omega_dot)
_ELEMENTS = {
    "mercury": (0.38709927, 0.00000037, 0.20563593, 0.00001906,
                7.00497902, -0.00594749, 252.25032350, 149472.67411175,
                77.45779628, 0.16047689, 48.33076593, -0.12534081),
    "venus": (0.72333566, 0.00000390, 0.00677672, -0.00004107,
              3.39467605, -0.00078890, 181.97909950, 58517.81538729,
              131.60246718, 0.00268329, 76.67984255, -0.27769418),
    "emb": (1.00000261, 0.00000562, 0.01671123, -0.00004392,
            -0.00001531, -0.01294668, 100.46457166, 35999.37244981,
            102.93768193, 0.32327364, 0.0, 0.0),
    "mars": (1.52371034, 0.00001847, 0.09339410, 0.00007882,
             1.84969142, -0.00813131, -4.55343205, 19140.30268499,
             -23.94362959, 0.44441088, 49.55953891, -0.29257343),
    "jupiter": (5.20288700, -0.00011607, 0.04838624, -0.00013253,
                1.30439695, -0.00183714, 34.39644051, 3034.74612775,
                14.72847983, 0.21252668, 100.47390909, 0.20469106),
    "saturn": (9.53667594, -0.00125060, 0.05386179, -0.00050991,
               2.48599187, 0.00193609, 49.95424423, 1222.49362201,
               92.59887831, -0.41897216, 113.66242448, -0.28867794),
    "uranus": (19.18916464, -0.00196176, 0.04725744, -0.00004397,
               0.77263783, -0.00242939, 313.23810451, 428.48202785,
               170.95427630, 0.40805281, 74.01692503, 0.04240589),
    "neptune": (30.06992276, 0.00026291, 0.00859048, 0.00005105,
                1.77004347, 0.00035372, -55.12002969, 218.45945325,
                44.96476227, -0.32241464, 131.78422574, -0.00508664),
}

# Mass ratios M_body / M_sun (IAU/DE-series values)
_MASS_RATIO = {
    "mercury": 1.0 / 6023600.0,
    "venus": 1.0 / 408523.71,
    "emb": 1.0 / 328900.56,
    "mars": 1.0 / 3098708.0,
    "jupiter": 1.0 / 1047.3486,
    "saturn": 1.0 / 3497.898,
    "uranus": 1.0 / 22902.98,
    "neptune": 1.0 / 19412.24,
}
_MOON_EARTH_RATIO = 1.0 / 81.30056  # M_moon / M_earth


def _kepler_solve(M, e, iters=12):
    """Newton iteration for E − e sinE = M (host; always converges for
    planetary e < 0.25 with E0 = M)."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _ecl_to_icrs(v):
    """Rotate ecliptic-J2000 → equatorial-J2000 (R1(−ε0))."""
    ce, se = np.cos(EPS0), np.sin(EPS0)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x, ce * y - se * z, se * y + ce * z], -1)


def _helio_pos(body, tdb_mjd):
    """Heliocentric ecliptic-J2000 position [au] of a planet/EMB."""
    (a0, ad, e0, ed, I0, Id, L0, Ld, w0, wd, O0, Od) = _ELEMENTS[body]
    t = (np.asarray(tdb_mjd, np.float64) - MJD_J2000) / 36525.0
    d2r = np.pi / 180.0
    a = (a0 + ad * t) * 1.0
    e = e0 + ed * t
    inc = (I0 + Id * t) * d2r
    L = (L0 + Ld * t) * d2r
    varpi = (w0 + wd * t) * d2r
    Om = (O0 + Od * t) * d2r
    w = varpi - Om  # argument of perihelion
    M = np.remainder(L - varpi, 2 * np.pi)
    E = _kepler_solve(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1 - e * e) * np.sin(E)
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return np.stack([x, y, z], -1)


def _moon_geo_pos(tdb_mjd):
    """Geocentric Moon, ecliptic-J2000 [m] (Meeus truncated; λ precessed
    from of-date back to J2000 via −5029.0966″/cy)."""
    t = (np.asarray(tdb_mjd, np.float64) - MJD_J2000) / 36525.0
    d2r = np.pi / 180.0
    Lp = (218.3164477 + 481267.88123421 * t) * d2r
    D = (297.8501921 + 445267.1114034 * t) * d2r
    M = (357.5291092 + 35999.0502909 * t) * d2r
    Mp = (134.9633964 + 477198.8675055 * t) * d2r
    F = (93.2720950 + 483202.0175233 * t) * d2r
    lon = Lp + d2r * (
        6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
        + 0.658314 * np.sin(2 * D) + 0.213618 * np.sin(2 * Mp)
        - 0.185116 * np.sin(M) - 0.114332 * np.sin(2 * F))
    lat = d2r * (
        5.128122 * np.sin(F) + 0.280602 * np.sin(Mp + F)
        + 0.277693 * np.sin(Mp - F) + 0.173237 * np.sin(2 * D - F))
    r = 1e3 * (385000.56 - 20905.355 * np.cos(Mp)
               - 3699.111 * np.cos(2 * D - Mp) - 2955.968 * np.cos(2 * D)
               - 569.925 * np.cos(2 * Mp))
    # of-date → J2000 ecliptic longitude
    lon = lon - (5029.0966 / 3600.0) * d2r * t
    cl, sl = np.cos(lat), np.sin(lat)
    return np.stack([r * cl * np.cos(lon), r * cl * np.sin(lon),
                     r * sl], -1)


_sun_cache = {}


def _sun_wrt_ssb_ecl(tdb_mjd):
    """Sun wrt SSB, ecliptic-J2000 [m]: −Σ μ_i r_i / (1 + Σ μ_i).

    Memoized on the epoch array: every body queried at the same epochs
    shares one 8-planet Kepler-solve sweep (compute_posvels hits this
    with identical arrays for earth/sun/each planet)."""
    tdb_mjd = np.asarray(tdb_mjd, np.float64)
    key = (tdb_mjd.shape, tdb_mjd.tobytes())
    hit = _sun_cache.get(key)
    if hit is not None:
        return hit
    num = np.zeros(tdb_mjd.shape + (3,))
    mtot = 0.0
    for body, mu in _MASS_RATIO.items():
        num = num + mu * _helio_pos(body, tdb_mjd) * AU
        mtot += mu
    out = -num / (1.0 + mtot)
    if len(_sun_cache) > 8:
        _sun_cache.clear()
    _sun_cache[key] = out
    return out


def _pos_ssb_ecl(body, tdb_mjd):
    """Body wrt SSB, ecliptic-J2000 [m]."""
    tdb_mjd = np.asarray(tdb_mjd, np.float64)
    if body == "ssb":
        return np.zeros(tdb_mjd.shape + (3,))
    sun = _sun_wrt_ssb_ecl(tdb_mjd)
    if body == "sun":
        return sun
    if body in ("earth", "moon"):
        emb = _helio_pos("emb", tdb_mjd) * AU + sun
        moon_geo = _moon_geo_pos(tdb_mjd)
        f = _MOON_EARTH_RATIO / (1.0 + _MOON_EARTH_RATIO)
        earth = emb - f * moon_geo
        return earth if body == "earth" else earth + moon_geo
    if body == "emb":
        return _helio_pos("emb", tdb_mjd) * AU + sun
    return _helio_pos(body, tdb_mjd) * AU + sun


# NAIF-id and alias compatibility with SPKEphemeris — both providers must
# accept the same body designators (get_ephemeris silently substitutes one
# for the other).
_ID_TO_NAME = {
    0: "ssb", 1: "mercury", 2: "venus", 3: "emb", 4: "mars", 5: "jupiter",
    6: "saturn", 7: "uranus", 8: "neptune", 10: "sun", 301: "moon",
    399: "earth",
}
_ALIASES = {
    "jupiter_barycenter": "jupiter", "saturn_barycenter": "saturn",
    "uranus_barycenter": "uranus", "neptune_barycenter": "neptune",
}


def ssb_posvel(body, tdb_mjd, vel_dt_s: float = 60.0):
    """Position [m] and velocity [m/s] of `body` wrt the SSB in
    equatorial-J2000 (ICRS-aligned) coordinates at TDB MJD epoch(s).

    Velocity by central difference (±vel_dt_s); error ~1e-7 m/s for
    Earth — far below the ~mm/s needed for Doppler corrections.
    """
    if isinstance(body, (int, np.integer)):
        body = _ID_TO_NAME[int(body)]
    body = _ALIASES.get(body.lower(), body.lower())
    tdb_mjd = np.atleast_1d(np.asarray(tdb_mjd, np.float64))
    h = vel_dt_s / DAY
    p = _ecl_to_icrs(_pos_ssb_ecl(body, tdb_mjd))
    pp = _ecl_to_icrs(_pos_ssb_ecl(body, tdb_mjd + h))
    pm = _ecl_to_icrs(_pos_ssb_ecl(body, tdb_mjd - h))
    v = (pp - pm) / (2 * vel_dt_s)
    return p, v
