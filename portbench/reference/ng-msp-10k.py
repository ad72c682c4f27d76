"""Plain reference of the 10,000-TOA MSP's chi-squared grid, and the
benchmark's own TOA inputs.

Inputs. The TOAs are the benchmark's: their UTC and TDB epochs, the
observatory's position and velocity relative to the solar-system
barycentre (SSB) and the Sun's position relative to the observatory come
from ``geometry`` (a Keplerian Earth orbit, the Sun's reflex about the
SSB from Jupiter, and the Green Bank site turning with the Earth), not
from the program's ephemeris. ``simulate`` moves each TOA onto an integer
pulse of this reference's own phase and adds white, ECORR and red noise
drawn from the seed and the noise model. Both the program and the
reference read these same columns.

Model (PINT's conventions, as the par file states them): a sky position
with proper motion and parallax gives the Roemer and parallax delays,
the Sun's Shapiro delay, the dispersion of DM(t) + DMX at the Doppler-
shifted barycentric frequency; spin phase F0 dt + F1 dt^2/2 + F2 dt^3/6
with dt the delay-subtracted TDB seconds since PEPOCH, phase jumps
-JUMP F0 on their flagged TOAs, the phase at the TZR TOA subtracted. The
residual is the fractional phase over F0, less its weighted mean.

Grid node. F0 and F1 are held at the node; the other free parameters
start at the par file's values and take ``maxiter`` Gauss-Newton steps
dp = -(M^T C^-1 M)^-1 M^T C^-1 r (an offset column in M, r the
mean-subtracted residuals); the node's chi2 is r^T C^-1 r at the refit
point, with C = N + ECORR blocks + F diag(phi) F^T factored densely
(EFAC/EQUAD-scaled white noise, one ECORR block an observing epoch, the
power-law red noise on TNREDC Fourier modes of the TDB span).

The fractional phase keeps float64 exact where it matters: F0 splits
into a 24-bit part, whose product with the whole seconds since PEPOCH is
exact, and the rest. The design M is torch.func.jacfwd of the same
residual function. Plain torch in the dtype asked for; it imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SECONDS_PER_DAY = 86400.0
F_YEAR = 1.0 / (365.25 * SECONDS_PER_DAY)
C_M_S = 299_792_458.0
PC_LS = 3.085_677_581_49e16 / C_M_S
DM_CONST = 1.0 / 2.41e-4           # s MHz^2 / (pc cm^-3)
T_SUN_S = 4.925490947e-6           # G M_sun / c^3
MAS_RAD = math.pi / 180.0 / 3600.0 / 1000.0
AU_M = 1.495978707e11
OBLIQUITY = 84381.406 / 3600.0 * math.pi / 180.0
MJD_J2000 = 51544.5
GBT_ITRF_M = (882589.65, -4924872.32, 3943729.348)
# TAI - UTC [s] from each MJD on (2004-2015)
LEAP = ((0.0, 32.0), (53736.0, 33.0), (54832.0, 34.0), (56109.0, 35.0),
        (57204.0, 36.0))
F0_SPLIT = 2.0 ** 15                # F0 * 2^15 < 2^24 for F0 < 512 Hz


# ---------------------------------------------------------------- par file

def _sexagesimal(text, hours):
    sign = -1.0 if text.strip().startswith("-") else 1.0
    parts = [abs(float(x)) for x in text.strip().lstrip("+-").split(":")]
    deg = parts[0] + sum(p / 60.0 ** (i + 1) for i, p in
                         enumerate(parts[1:]))
    return sign * deg * (15.0 if hours else 1.0) * math.pi / 180.0


def parse_par(lines):
    """{name: value} of the par lines (angles in radians; JUMPn the n-th
    JUMP) and the JUMP, EFAC, EQUAD and ECORR entries as (kind, flag,
    flag value, value)."""
    vals, masks = {}, []
    for line in lines:
        w = line.split()
        key = w[0]
        if key in ("JUMP", "EFAC", "EQUAD", "ECORR"):
            masks.append((key, w[1].lstrip("-"), w[2], float(w[3])))
            if key == "JUMP":
                vals[f"JUMP{sum(m[0] == 'JUMP' for m in masks)}"] = \
                    float(w[3])
        elif key in ("RAJ", "DECJ"):
            vals[key] = _sexagesimal(w[1], key == "RAJ")
        elif key in ("PSR", "UNITS", "TZRSITE"):
            vals[key] = w[1]
        else:
            vals[key] = float(w[1])
    return vals, masks


def free_names(cfg):
    """The free parameters a grid node refits, in this reference's order:
    astrometry, DMX windows, F2, the JUMPs."""
    ndmx = int(cfg["ndmx"])
    njump = int(cfg["jump_groups"]) - 1
    return (["PX", "RAJ", "DECJ", "PMRA", "PMDEC"]
            + [f"DMX_{i + 1:04d}" for i in range(ndmx)] + ["F2"]
            + [f"JUMP{i + 1}" for i in range(njump)])


def par_lines(cfg):
    """The configuration's par file: its fixed lines, the JUMPs, then
    ``ndmx`` free DMX windows tiling the span."""
    lines = list(cfg["par"])
    lines += [f"JUMP -grp g{i} 1e-6 1"
              for i in range(int(cfg["jump_groups"]) - 1)]
    edges = np.linspace(*cfg["span_mjd"], int(cfg["ndmx"]) + 1)
    for i in range(int(cfg["ndmx"])):
        lines += [f"DMX_{i + 1:04d} 0.0 1",
                  f"DMXR1_{i + 1:04d} {edges[i]:.4f}",
                  f"DMXR2_{i + 1:04d} {edges[i + 1]:.4f}"]
    return lines


# ---------------------------------------------------------------- inputs

def _kepler(mean_anom, e):
    E = mean_anom + e * np.sin(mean_anom)
    for _ in range(8):
        E = E - (E - e * np.sin(E) - mean_anom) / (1.0 - e * np.cos(E))
    return E


def _ecliptic_to_equatorial(v):
    c, s = math.cos(OBLIQUITY), math.sin(OBLIQUITY)
    return np.stack([v[..., 0], c * v[..., 1] - s * v[..., 2],
                     s * v[..., 1] + c * v[..., 2]], axis=-1)


def geometry(mjd_tdb, mjd_utc):
    """(observatory wrt SSB [m], its velocity [m/s], Sun wrt observatory
    [m]) at the given epochs: the Earth on a Keplerian orbit about the
    Sun, the Sun on a circle about the SSB opposite Jupiter, and the
    Green Bank site turning at the Earth rotation angle (no precession
    or nutation: these are the benchmark's inputs, not an ephemeris)."""
    d = np.asarray(mjd_tdb, np.float64) - MJD_J2000
    a, e = 1.00000261 * AU_M, 0.01671123
    n = 2.0 * math.pi / 365.256363004 / SECONDS_PER_DAY
    varpi = math.radians(102.93768193)
    M = math.radians(100.46457166) - varpi + n * SECONDS_PER_DAY * d
    E = _kepler(np.mod(M, 2.0 * math.pi), e)
    b = a * math.sqrt(1.0 - e * e)
    edot = n / (1.0 - e * np.cos(E))
    xo, yo = a * (np.cos(E) - e), b * np.sin(E)
    vxo, vyo = -a * np.sin(E) * edot, b * np.cos(E) * edot
    cw, sw = math.cos(varpi), math.sin(varpi)
    z = np.zeros_like(d)
    helio = np.stack([cw * xo - sw * yo, sw * xo + cw * yo, z], -1)
    vhelio = np.stack([cw * vxo - sw * vyo, sw * vxo + cw * vyo, z], -1)
    # the Sun about the SSB: Jupiter's reflex on a circle
    rj = 5.20288700 * AU_M / 1047.3486
    nj = 2.0 * math.pi / 4332.589 / SECONDS_PER_DAY
    lj = math.radians(34.39644051) + nj * SECONDS_PER_DAY * d + math.pi
    sun = np.stack([rj * np.cos(lj), rj * np.sin(lj), z], -1)
    vsun = np.stack([-rj * nj * np.sin(lj), rj * nj * np.cos(lj), z], -1)
    earth = _ecliptic_to_equatorial(sun + helio)
    vearth = _ecliptic_to_equatorial(vsun + vhelio)
    # the site: ITRF turned by the Earth rotation angle about the pole
    du = np.asarray(mjd_utc, np.float64) - MJD_J2000
    era = 2.0 * math.pi * np.mod(0.7790572732640 + 0.00273781191135448 * du
                                 + np.mod(du, 1.0), 1.0)
    w = 2.0 * math.pi * 1.00273781191135448 / SECONDS_PER_DAY
    x, y, zz = GBT_ITRF_M
    ce, se = np.cos(era), np.sin(era)
    site = np.stack([ce * x - se * y, se * x + ce * y,
                     np.full_like(ce, zz)], -1)
    vsite = w * np.stack([-se * x - ce * y, ce * x - se * y,
                          np.zeros_like(ce)], -1)
    obs = earth + site
    return obs, vearth + vsite, _ecliptic_to_equatorial(sun) - obs


def tdb_minus_utc(mjd_utc):
    """TDB - UTC [s]: TAI - UTC from the leap-second table, 32.184 s, and
    the leading 1.657 ms annual term."""
    m = np.asarray(mjd_utc, np.float64)
    tai = np.zeros_like(m)
    for start, v in LEAP:
        tai = np.where(m >= start, v, tai)
    g = math.radians(357.53) + 0.98560028 * math.pi / 180.0 * (m - MJD_J2000)
    return tai + 32.184 + 1.657e-3 * np.sin(g)


def epochs(cfg):
    """UTC MJDs, radio frequencies [MHz], TOA errors [us] and flags of
    the configuration's TOAs: ``ntoas / toas_per_epoch`` observing epochs
    spread over the span, each a few TOAs minutes apart in two bands."""
    per = int(cfg["toas_per_epoch"])
    nep = int(cfg["ntoas"]) // per
    lo, hi = cfg["span_mjd"]
    centres = np.linspace(lo + 1.0, hi - 1.0, nep)
    mjd = (centres[:, None] + np.asarray(cfg["epoch_offsets_d"])[None, :]
           ).ravel()
    freq = np.tile(np.asarray(cfg["freqs_mhz"], np.float64), nep)
    err = np.full(len(mjd), float(cfg["error_us"]))
    ngrp = int(cfg["jump_groups"])
    flags = [{"be": "X", "grp": f"g{i % ngrp}"} for i in range(len(mjd))]
    return mjd, freq, err, flags


def _columns(day, frac, freq, err, flags):
    """The TOA columns both sides read, from UTC days and fractions."""
    utc = day + frac
    dt = tdb_minus_utc(utc) / SECONDS_PER_DAY
    tfrac = frac + dt
    tday = day + np.floor(tfrac)
    tfrac = tfrac - np.floor(tfrac)
    pos, vel, sun = geometry(tday + tfrac, utc)
    return {"mjd_day": day, "mjd_frac_hi": frac,
            "mjd_frac_lo": np.zeros_like(frac), "freq_mhz": freq,
            "error_us": err, "flags": flags, "tdb_day": tday,
            "tdb_frac_hi": tfrac, "tdb_frac_lo": np.zeros_like(tfrac),
            "ssb_obs_pos": pos, "ssb_obs_vel": vel, "obs_sun_pos": sun}


def _shift(cols, seconds):
    """The same TOAs moved by ``seconds`` (UTC and TDB alike; the
    geometry stays where it was, a shift of microseconds)."""
    out = dict(cols)
    for d, f in (("mjd_day", "mjd_frac_hi"), ("tdb_day", "tdb_frac_hi")):
        fr = cols[f] + seconds / SECONDS_PER_DAY
        out[d] = cols[d] + np.floor(fr)
        out[f] = fr - np.floor(fr)
    return out


def simulate(cfg, seed, device):
    """The benchmark's TOA columns for ``seed``: the configuration's
    epochs moved onto integer pulses of the par file's model, then white
    (EFAC/EQUAD-scaled), ECORR and red noise added, each drawn on
    ``device`` from the seed. The epochs, and so every size, are the same
    for every seed."""
    mjd, freq, err, flags = epochs(cfg)
    day = np.floor(mjd)
    cols = _columns(day, mjd - day, freq, err, flags)
    model = Model(cfg, cols, device, torch.float64)
    p0 = model.p0()
    for _ in range(3):
        r = model.residuals(p0, model.f0, model.f1, mean=False)
        cols = _shift(cols, -r.cpu().numpy())
        model = Model(cfg, cols, device, torch.float64)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(device=device, dtype=torch.float64)
    n, nep = len(mjd), int(model.eid.max()) + 1
    white = torch.randn(n, generator=g, **f64) * torch.sqrt(model.nvec)
    jit = torch.randn(nep, generator=g, **f64)[model.eid] \
        * math.sqrt(model.ecorr_var)
    red = model.F @ (torch.randn(model.F.shape[1], generator=g, **f64)
                     * torch.sqrt(model.phi))
    return _shift(cols, (white + jit + red).cpu().numpy())


# ---------------------------------------------------------------- model

class Model:
    """The par file's timing and noise model over one set of TOA columns,
    in ``dtype`` on ``device``."""

    def __init__(self, cfg, cols, device, dtype):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.vals, masks = parse_par(par_lines(cfg))
        self.names = free_names(cfg)
        t = dict(device=device, dtype=dtype)
        v = self.vals
        pep = v["PEPOCH"]
        self.sec = torch.as_tensor((cols["tdb_day"] - pep) * SECONDS_PER_DAY,
                                   **t)
        self.frac_s = torch.as_tensor(
            (cols["tdb_frac_hi"] + cols["tdb_frac_lo"]) * SECONDS_PER_DAY, **t)
        tdb = cols["tdb_day"] + cols["tdb_frac_hi"] + cols["tdb_frac_lo"]
        self.tdb = torch.as_tensor(tdb, **t)
        self.robs = torch.as_tensor(cols["ssb_obs_pos"] / C_M_S, **t)
        self.vobs = torch.as_tensor(cols["ssb_obs_vel"] / C_M_S, **t)
        self.rsun = torch.as_tensor(cols["obs_sun_pos"] / C_M_S, **t)
        self.freq = torch.as_tensor(cols["freq_mhz"], **t)
        utc = cols["mjd_day"] + cols["mjd_frac_hi"] + cols["mjd_frac_lo"]
        ndmx = int(cfg["ndmx"])
        dmx = np.stack([(utc >= v[f"DMXR1_{i + 1:04d}"])
                        & (utc <= v[f"DMXR2_{i + 1:04d}"])
                        for i in range(ndmx)], axis=1)
        self.dmx = torch.as_tensor(dmx, **t)
        jumps = [m for m in masks if m[0] == "JUMP"]
        self.jump = torch.as_tensor(np.stack(
            [[f[m[1]] == m[2] for f in cols["flags"]] for m in jumps],
            axis=1), **t)
        self.f0, self.f1 = v["F0"], v["F1"]
        # the TZR TOA: at the SSB, TDB = TZRMJD, at TZRFRQ
        tz = v["TZRMJD"]
        tzd = math.floor(tz)
        _, _, sun = geometry(np.array([tz]), np.array([tz]))
        self.tzr = {
            "sec": torch.as_tensor([(tzd - pep) * SECONDS_PER_DAY], **t),
            "frac_s": torch.as_tensor([(tz - tzd) * SECONDS_PER_DAY], **t),
            "tdb": torch.as_tensor([tz], **t),
            "robs": torch.zeros(1, 3, **t), "vobs": torch.zeros(1, 3, **t),
            "rsun": torch.as_tensor(sun / C_M_S, **t),
            "freq": torch.as_tensor([v["TZRFRQ"]], **t),
            "dmx": torch.as_tensor(np.array([[
                v[f"DMXR1_{i + 1:04d}"] <= tz <= v[f"DMXR2_{i + 1:04d}"]
                for i in range(ndmx)]]), **t),
            "jump": torch.zeros(1, len(jumps), **t)}
        # noise: EFAC^2 (sigma^2 + EQUAD^2), ECORR epochs, red noise
        efac = [m[3] for m in masks if m[0] == "EFAC"][0]
        equad = [m[3] for m in masks if m[0] == "EQUAD"][0]
        ecorr = [m[3] for m in masks if m[0] == "ECORR"][0]
        sig2 = (cols["error_us"] * 1e-6) ** 2 + (equad * 1e-6) ** 2
        self.nvec = torch.as_tensor(efac ** 2 * sig2, **t)
        self.ecorr_var = (ecorr * 1e-6) ** 2
        order = np.argsort(utc, kind="stable")
        gaps = np.diff(utc[order]) > 0.5
        eid = np.empty(len(utc), np.int64)
        eid[order] = np.concatenate([[0], np.cumsum(gaps)])
        self.eid = torch.as_tensor(eid, device=device)
        ts = (cols["tdb_day"] - cols["tdb_day"].min() + cols["tdb_frac_hi"]
              + cols["tdb_frac_lo"]) * SECONDS_PER_DAY
        tspan = float(ts.max() - ts.min())
        k = torch.arange(1, int(v["TNREDC"]) + 1, device=device,
                         dtype=torch.float64) / tspan
        arg = 2.0 * math.pi * torch.as_tensor(ts, device=device,
                                              dtype=torch.float64)[:, None] \
            * k[None, :]
        self.F = torch.stack([torch.sin(arg), torch.cos(arg)], -1).reshape(
            len(ts), -1).to(dtype)
        fk = k.repeat_interleave(2)
        lw = 2.0 * math.log(10.0) * v["TNREDAMP"] \
            - math.log(12.0 * math.pi ** 2) \
            + (v["TNREDGAM"] - 3.0) * math.log(F_YEAR) + math.log(1.0 / tspan)
        self.phi = torch.exp(lw - v["TNREDGAM"] * torch.log(fk)).to(dtype)
        self._chol = None

    def p0(self):
        """The free parameters at the par file's values."""
        return torch.as_tensor([self.vals[n] for n in self.names],
                               device=self.device, dtype=self.dtype)

    def _phase(self, p, f0, f1, b):
        """Fractional pulse phase of the TOAs in ``b`` (before the TZR
        subtraction)."""
        v, ndmx = self.vals, int(self.cfg["ndmx"])
        px, ra, dec, pmra, pmdec = p[0], p[1], p[2], p[3], p[4]
        dmx, f2, jump = p[5:5 + ndmx], p[5 + ndmx], p[6 + ndmx:]
        dt_yr = (b["tdb"] - v["POSEPOCH"]) / 365.25
        a = ra + pmra * MAS_RAD * dt_yr / torch.cos(dec)
        d = dec + pmdec * MAS_RAD * dt_yr
        n = torch.stack([torch.cos(d) * torch.cos(a),
                         torch.cos(d) * torch.sin(a), torch.sin(d)], -1)
        r = b["robs"]
        rn = torch.sum(r * n, -1)
        delay = -rn + (torch.sum(r * r, -1) - rn * rn) * (px * 1e-3) \
            / (2.0 * PC_LS)
        rs = b["rsun"]
        delay = delay - 2.0 * T_SUN_S * torch.log(
            torch.sqrt(torch.sum(rs * rs, -1)) - torch.sum(rs * n, -1))
        bfreq = b["freq"] * (1.0 - torch.sum(b["vobs"] * n, -1))
        dt_dm = (b["tdb"] - v["DMEPOCH"]) / 365.25
        dm = v["DM"] + v["DM1"] * dt_dm + v["DM2"] * dt_dm ** 2 / 2.0 \
            + b["dmx"] @ dmx
        delay = delay + DM_CONST * dm / (bfreq * bfreq)
        # spin phase: F0 = fa + fb, fa * (whole seconds) exact
        fa = math.floor(f0 * F0_SPLIT + 0.5) / F0_SPLIT
        fb = f0 - fa
        rest = b["frac_s"] - delay
        t = b["sec"] + rest

        def frac(x):
            return x - torch.round(x)

        ph = frac(fa * b["sec"]) + frac(fb * b["sec"]) + f0 * rest \
            + f1 * t * t / 2.0 + f2 * t * t * t / 6.0
        ph = ph - (b["jump"] @ jump) * f0
        return frac(ph)

    def _batch(self):
        return {"sec": self.sec, "frac_s": self.frac_s, "tdb": self.tdb,
                "robs": self.robs, "vobs": self.vobs, "rsun": self.rsun,
                "freq": self.freq, "dmx": self.dmx, "jump": self.jump}

    def residuals(self, p, f0, f1, mean=True):
        """Time residuals [s] at parameters ``p`` and the node (f0, f1),
        less their weighted mean unless ``mean`` is False."""
        ph = self._phase(p, f0, f1, self._batch()) \
            - self._phase(p, f0, f1, self.tzr)
        r = (ph - torch.round(ph)) / f0
        if mean:
            w = 1.0 / self.nvec
            r = r - torch.sum(r * w) / torch.sum(w)
        return r

    def chol(self):
        """Cholesky factor of C [us^2], made once."""
        if self._chol is None:
            same = (self.eid[:, None] == self.eid[None, :]).to(self.dtype)
            C = same * (self.ecorr_var * 1e12)
            C = C + (self.F * (self.phi * 1e12)) @ self.F.T
            C.diagonal().add_(self.nvec * 1e12)
            del same
            self._chol = torch.linalg.cholesky(C)
        return self._chol

    def whiten(self, x):
        """L^-1 x for x in seconds, in units of sigma."""
        L = self.chol()
        return torch.linalg.solve_triangular(
            L, (x * 1e6).reshape(len(x), -1), upper=False)

    def node_chi2(self, f0, f1, maxiter):
        """chi2 at the node (f0, f1) after ``maxiter`` refit steps."""
        p = self.p0()
        for _ in range(maxiter):
            M = torch.func.jacfwd(
                lambda q: self.residuals(q, f0, f1, mean=False))(p)
            r = self.residuals(p, f0, f1)
            off = torch.full((len(r), 1), 1.0 / f0, device=self.device,
                             dtype=self.dtype)
            Mw = self.whiten(torch.cat([off, M], 1))
            rw = self.whiten(r)[:, 0]
            # columns to unit largest entry (a norm of F2's column
            # overflows float32); QR least squares, as on the card
            scale = torch.amax(torch.abs(Mw), dim=0)
            x = torch.linalg.lstsq(Mw / scale, rw[:, None],
                                   driver="gels").solution[:, 0]
            p = p - (x / scale)[1:]
        rw = self.whiten(self.residuals(p, f0, f1))[:, 0]
        return torch.sum(rw * rw)


def spin_sigma(cols, cfg, device):
    """The standard errors of F0 and F1 in a fit of every free parameter
    at the par file's values: the grid's scale (the traffic file holds
    them, read once at the configuration's size; they depend on the
    epochs and the noise model, not on the seed's draw)."""
    model = Model(cfg, cols, device, torch.float64)
    p = model.p0()
    M = torch.func.jacfwd(
        lambda q: model.residuals(q, model.f0, model.f1, mean=False))(p)
    b = model._batch()
    t = b["sec"] + b["frac_s"]
    spin = torch.stack([t, t * t / 2.0], 1) / model.f0
    off = torch.full((len(t), 1), 1.0 / model.f0, device=device,
                     dtype=torch.float64)
    Mw = model.whiten(torch.cat([off, M, spin], 1))
    scale = torch.amax(torch.abs(Mw), dim=0)
    cov = torch.linalg.inv((Mw / scale).T @ (Mw / scale)) \
        / torch.outer(scale, scale)
    return torch.sqrt(torch.diagonal(cov)[-2:]).cpu().numpy()


def grid_chi2(cols, cfg, nodes, device, dtype=torch.float64):
    """The refit chi2 at each (F0, F1) row of ``nodes``, as float64 numpy;
    NaN where ``dtype`` gives no value."""
    model = Model(cfg, cols, device, dtype)
    out = []
    for f0, f1 in np.asarray(nodes, np.float64):
        try:
            c = float(model.node_chi2(float(f0), float(f1),
                                      int(cfg["maxiter"])))
        except torch.linalg.LinAlgError:
            c = float("nan")
        out.append(c)
    return np.asarray(out)
