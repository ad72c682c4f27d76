"""Plain reference of the NICER PSR J0030+0451 photon fit, and the
benchmark's own photon inputs.

The deployment is PINT's ``event_optimize`` on barycentred NICER events
(Bogdanov et al. 2019, ApJL 887, L25): the unbinned template likelihood

    log L(theta) = sum_i log(w_i f(phi_i(theta)) + 1 - w_i),  w_i = 1,

over the spin parameters (F0, F1), f a template of three wrapped
Gaussians over a flat background, and the H-test at m = 20 (de Jager
1989) of the photons' phases.

Inputs. Photon times are TDB at the solar-system barycentre (site '@').
``simulate`` draws each photon's pulse phase from the template, a time
uniform over the span, and moves the time (three Newton steps) onto that
phase under this reference's own spin phase, the Sun's Shapiro delay
included. A time is whole days, ticks of 2^-40 day within the day, and
seconds below a tick, so every product below is exact where it must be;
the program reads the same times as a double-double day fraction. The
Sun's position about the barycentre is the benchmark's own (a circle
opposite Jupiter), not an ephemeris.

Model. The phase of photon i is F0 dt + F1 dt^2 / 2, dt the TDB seconds
since PEPOCH less the Sun's Shapiro delay -2 T_sun ln(r - r.n) (r the
Sun from the barycentre in light-seconds, n the pulsar's direction from
RAJ/DECJ), taken modulo one turn. Departures from the published model,
each the program's own: PINT applies no Shapiro delay to barycentred
TOAs, and the program (after the JAX package) does, so this reference
does too; each wrapped Gaussian sums the images -3..3 of its peak, as
the program's template does, where the published template wraps without
bound (the terms left out are below exp(-0.5 (3 / 0.12)^2) at the
widest width here).

A point theta holds the float64 values of (F0, F1), a walker's and the
H-test's alike: the program reads the par file's values into float64
(their double-double low words are zero), and a walker moves them.

Precision. F0 splits into a part on a 2^-15 grid, whose product with the
whole seconds since PEPOCH is exact in float64, and the rest. Plain
torch in the dtype asked for; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SECONDS_PER_DAY = 86400.0
C_M_S = 299_792_458.0
AU_M = 1.495978707e11
T_SUN_S = 4.925490947e-6           # G M_sun / c^3
OBLIQUITY = 84381.406 / 3600.0 * math.pi / 180.0
MJD_J2000 = 51544.5
TICK_BITS = 40
TICK_S = SECONDS_PER_DAY * 2.0 ** -TICK_BITS   # 675 * 2^-33 s, exact
F0_SPLIT = 2.0 ** 15                # F0 * 2^15 < 2^24 for F0 < 512 Hz
IMAGES = range(-3, 4)
NEWTON_STEPS = 3
BLOCK = 1 << 18                     # photons a block of the reference


# ---------------------------------------------------------------- par file

def _sexagesimal(text, hours):
    sign = -1.0 if text.strip().startswith("-") else 1.0
    parts = [abs(float(x)) for x in text.strip().lstrip("+-").split(":")]
    deg = parts[0] + sum(p / 60.0 ** (i + 1) for i, p in
                         enumerate(parts[1:]))
    return sign * deg * (15.0 if hours else 1.0) * math.pi / 180.0


def par_lines(cfg):
    """The configuration's par file."""
    return list(cfg["par"])


def par_values(cfg):
    """{name: the par file's text} of every line."""
    out = {}
    for line in par_lines(cfg):
        w = line.split()
        out[w[0]] = w[1]
    return out


def pulsar_direction(cfg):
    """Unit vector from the barycentre to the pulsar (ICRS)."""
    v = par_values(cfg)
    a = _sexagesimal(v["RAJ"], True)
    d = _sexagesimal(v["DECJ"], False)
    return (math.cos(d) * math.cos(a), math.cos(d) * math.sin(a),
            math.sin(d))


def spin(theta):
    """(fa, fb, f0, f1) of a point theta = (F0, F1): F0 = fa + fb exactly,
    fa on the 2^-15 grid."""
    f0, f1 = (float(x) for x in theta)
    fa = math.floor(f0 * F0_SPLIT + 0.5) / F0_SPLIT
    return fa, f0 - fa, f0, f1


# ---------------------------------------------------------------- inputs

def sun_from_ssb(mjd_tdb):
    """The Sun's position [m] about the barycentre, equatorial: Jupiter's
    reflex on a circle (the benchmark's inputs, not an ephemeris)."""
    d = np.asarray(mjd_tdb, np.float64) - MJD_J2000
    rj = 5.20288700 * AU_M / 1047.3486
    nj = 2.0 * math.pi / 4332.589 / SECONDS_PER_DAY
    lj = math.radians(34.39644051) + nj * SECONDS_PER_DAY * d + math.pi
    x, y = rj * np.cos(lj), rj * np.sin(lj)
    c, s = math.cos(OBLIQUITY), math.sin(OBLIQUITY)
    return np.stack([x, c * y, s * y], axis=-1)


def template_params(cfg):
    """(norms, locs, widths) of the template's three Gaussians."""
    t = cfg["assumed"]["template"]
    return (np.asarray(t["norms"], np.float64),
            np.asarray(t["locs"], np.float64),
            np.asarray(t["widths"], np.float64))


def _draw_phases(cfg, g, n, device):
    """Pulse phases drawn from the template: a component by its norm (the
    background by the rest), then a Gaussian about its location, wrapped,
    or a uniform phase."""
    norms, locs, widths = template_params(cfg)
    f64 = dict(device=device, dtype=torch.float64)
    pick = torch.rand(n, generator=g, **f64)
    gauss = torch.randn(n, generator=g, **f64)
    flat = torch.rand(n, generator=g, **f64)
    edges = torch.as_tensor(np.cumsum(norms), **f64)
    comp = torch.searchsorted(edges, pick, right=True)
    pulsed = comp < len(norms)
    k = torch.clamp(comp, max=len(norms) - 1)
    loc = torch.as_tensor(locs, **f64)[k]
    wid = torch.as_tensor(widths, **f64)[k]
    return torch.where(pulsed, torch.remainder(loc + wid * gauss, 1.0), flat)


def _shapiro(sun_m, n, dtype):
    """The Sun's Shapiro delay [s] for photons at the barycentre."""
    rs = sun_m.to(dtype) / C_M_S
    nv = torch.as_tensor(n, device=rs.device, dtype=dtype)
    r = torch.sqrt(torch.sum(rs * rs, -1))
    return -2.0 * T_SUN_S * torch.log(r - torch.sum(rs * nv, -1))


def _phase(day, tick, sub_s, sun_m, cfg, sp, dtype):
    """Fractional spin phase in [0, 1) of photons at (whole days, ticks,
    seconds below a tick) for spin (fa, fb, f0, f1), in ``dtype``."""
    fa, fb, f0, f1 = sp
    pep = float(par_values(cfg)["PEPOCH"])
    ts = tick.to(torch.float64) * TICK_S          # exact: < 2^50 * 2^-33
    whole = torch.floor(ts)
    W = ((day.to(torch.float64) - pep) * SECONDS_PER_DAY + whole).to(dtype)
    u = (ts - whole).to(dtype) + sub_s.to(dtype) \
        - _shapiro(sun_m, pulsar_direction(cfg), dtype)
    t = W + u

    def frac(x):
        return x - torch.round(x)

    ph = frac(fa * W) + frac(fb * W) + f0 * u + f1 * t * t / 2.0
    return torch.remainder(ph, 1.0)


def _renormalize(day, tick, sub_s):
    """Carry seconds below a tick into ticks, and ticks into days."""
    carry = torch.floor(sub_s / TICK_S)
    sub_s = sub_s - carry * TICK_S
    tick = tick + carry.to(torch.int64)
    dcarry = torch.div(tick, 1 << TICK_BITS, rounding_mode="floor")
    return day + dcarry, tick - (dcarry << TICK_BITS), sub_s


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def simulate(cfg, seed, device):
    """The photons for ``seed`` (module docstring), as host arrays: the
    reference's own times (``day``, ``tick``, ``sub_s``), the Sun's
    position ``obs_sun_pos`` [m], and the columns the program reads (UTC
    and TDB alike for barycentred events: whole days and a double-double
    day fraction; the observatory at the barycentre). The photon count
    and the span are the configuration's and do not depend on the
    seed."""
    a = cfg["assumed"]
    n = int(a["photons"])
    lo, hi = (float(x) for x in a["span_mjd"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(device=device, dtype=torch.float64)
    target = _draw_phases(cfg, g, n, device)
    t0 = lo + (hi - lo) * torch.rand(n, generator=g, **f64)
    order = torch.argsort(t0)
    t0, target = t0[order], target[order]
    day = torch.floor(t0).to(torch.int64)
    x = (t0 - torch.floor(t0)) * 2.0 ** TICK_BITS
    tick = torch.floor(x).to(torch.int64)
    sub_s = (x - torch.floor(x)) * TICK_S
    sun = torch.as_tensor(sun_from_ssb(t0.cpu().numpy()), **f64)
    v = par_values(cfg)
    sp = spin((float(v["F0"]), float(v["F1"])))
    pep = float(v["PEPOCH"])
    for _ in range(NEWTON_STEPS):
        ph = _phase(day, tick, sub_s, sun, cfg, sp, torch.float64)
        err = torch.remainder(ph - target + 0.5, 1.0) - 0.5
        dt = (day.to(torch.float64) - pep) * SECONDS_PER_DAY
        sub_s = sub_s - err / (sp[2] + sp[3] * dt)
        day, tick, sub_s = _renormalize(day, tick, sub_s)
    frac_hi, frac_lo = _two_sum(tick.to(torch.float64) * 2.0 ** -TICK_BITS,
                                sub_s / SECONDS_PER_DAY)
    host = {k: x.cpu().numpy() for k, x in (
        ("day", day), ("tick", tick), ("sub_s", sub_s),
        ("frac_hi", frac_hi), ("frac_lo", frac_lo), ("obs_sun_pos", sun))}
    d = host["day"].astype(np.float64)
    zeros = np.zeros((n, 3))
    return {"day": host["day"], "tick": host["tick"], "sub_s": host["sub_s"],
            "mjd_day": d, "mjd_frac_hi": host["frac_hi"],
            "mjd_frac_lo": host["frac_lo"], "tdb_day": d,
            "tdb_frac_hi": host["frac_hi"], "tdb_frac_lo": host["frac_lo"],
            "freq_mhz": np.full(n, np.inf), "error_us": np.zeros(n),
            "ssb_obs_pos": zeros, "ssb_obs_vel": zeros,
            "obs_sun_pos": host["obs_sun_pos"]}


# ---------------------------------------------------------------- model

class Photons:
    """The photons of ``cols`` on ``device``, in blocks of BLOCK."""

    def __init__(self, cols, device):
        self.n = len(cols["day"])
        self.blocks = []
        for s in range(0, self.n, BLOCK):
            sl = slice(s, s + BLOCK)
            self.blocks.append(tuple(
                torch.as_tensor(cols[k][sl], device=device)
                for k in ("day", "tick", "sub_s", "obs_sun_pos")))


def template_pdf(phi, cfg):
    """The template's density at phases ``phi`` (in their dtype): the
    background 1 - sum(norms) plus each norm times its Gaussian, summed
    over the images -3..3."""
    norms, locs, widths = template_params(cfg)
    val = torch.full_like(phi, 1.0 - float(np.sum(norms)))
    for nk, lk, wk in zip(norms, locs, widths):
        g = torch.zeros_like(phi)
        for img in IMAGES:
            z = (phi - lk + img) / wk
            g = g + torch.exp(-0.5 * z * z)
        val = val + nk / (wk * math.sqrt(2.0 * math.pi)) * g
    return val


def lnlike(cols, cfg, thetas, device, dtype=torch.float64, photons=None):
    """log L [nats] at each point (row of ``thetas``: F0, F1), as float64
    numpy; computed in ``dtype``."""
    ph = photons or Photons(cols, device)
    out = []
    for th in np.asarray(thetas, np.float64):
        sp = spin(th)
        tot = torch.zeros((), device=device, dtype=torch.float64)
        for day, tick, sub_s, sun in ph.blocks:
            phi = _phase(day, tick, sub_s, sun, cfg, sp, dtype)
            tot = tot + torch.sum(torch.log(template_pdf(phi, cfg))).to(
                torch.float64)
        out.append(float(tot))
    return np.asarray(out)


def htest(cols, cfg, thetas, device, dtype=torch.float64, m=None):
    """The H-test at m harmonics (the configuration's ``htest_m``) of the
    photons' phases at each point (row of ``thetas``: F0, F1),
    unweighted: Z^2_k = (2 / N) sum_{j <= k} |sum_i
    exp(2 pi i j phi_i)|^2, H = max_k (Z^2_k - 4 k + 4). Computed in
    ``dtype``; float64 numpy."""
    m = int(cfg["htest_m"]) if m is None else int(m)
    ph = Photons(cols, device)
    ks = torch.arange(1, m + 1, device=device, dtype=dtype)
    out = []
    for th in np.asarray(thetas, np.float64):
        sp = spin(th)
        c = torch.zeros(m, device=device, dtype=dtype)
        s = torch.zeros(m, device=device, dtype=dtype)
        for day, tick, sub_s, sun in ph.blocks:
            phi = _phase(day, tick, sub_s, sun, cfg, sp, dtype)
            for j in range(m):
                arg = 2.0 * math.pi * ks[j] * phi
                c[j] = c[j] + torch.sum(torch.cos(arg))
                s[j] = s[j] + torch.sum(torch.sin(arg))
        z2 = torch.cumsum(2.0 * (c * c + s * s) / ph.n, 0)
        out.append(float(torch.max(z2 - 4.0 * ks + 4.0)))
    return np.asarray(out)


def spin_sigma(cols, cfg, device):
    """The standard errors of F0 and F1 from the curvature of log L at
    the par file's values (a quadratic through 3 x 3 points, twice: the
    second at the first's errors), as float64 numpy: the walkers' start
    scale. The inverse of the Hessian gives each error with the other
    parameter marginalized."""
    ph = Photons(cols, device)
    v = par_values(cfg)
    x0 = np.array([float(v["F0"]), float(v["F1"])])
    h = np.array([1e-11, 1e-18])
    offs = np.array([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)],
                    np.float64)
    for _ in range(2):
        ll = lnlike(cols, cfg, x0 + offs * h, device, photons=ph)
        A = np.stack([np.ones(9), offs[:, 0], offs[:, 1], offs[:, 0] ** 2,
                      offs[:, 0] * offs[:, 1], offs[:, 1] ** 2], 1)
        c = np.linalg.lstsq(A, ll, rcond=None)[0]
        H = np.array([[2 * c[3], c[4]], [c[4], 2 * c[5]]]) / np.outer(h, h)
        cov = np.linalg.inv(-H)
        h = np.sqrt(np.diag(cov))
    return h
