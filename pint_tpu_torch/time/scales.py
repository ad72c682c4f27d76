"""UTC → TAI → TT → TDB scale conversions on dd MJDs.

Replaces astropy.time scale chains + ERFA ``dtdb``
(reference: src/pint/toa.py TOAs.compute_TDBs; SURVEY.md Appendix A.3).

TDB−TT uses a truncated Fairhead–Bretagnon analytic series: 60 t^0
terms, 16 t^1 terms, 6 t^2 terms and the leading t^3 term of the
FB1990 expansion (the published constants, embedded as data). Honest
truncation estimate vs the full ~790-term series: the largest omitted
t^0 amplitude is ~0.028 µs and the omitted tail RSSes to ~0.1 µs
worst-case (the full table cannot be re-derived offline; the table is
data, so extending further stays mechanical). Independent-method
cross-check: tests/test_time_truth.py integrates the defining
relativistic rate with the in-repo ephemeris and agrees to <5 µs over
12 yr — limited by the Keplerian ephemeris's missing indirect
planetary perturbations of Earth's orbit, not by this series. The
additional topocentric term −(v_⊕·r_obs)/c² (~2 µs diurnal) is
applied in the TOA pipeline where the observatory GCRS vectors are
available.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.time.leapseconds import tai_minus_utc

TT_MINUS_TAI = 32.184  # seconds, exact
SECS_PER_DAY = 86400.0
MJD_J2000 = 51544.5  # TT

# Fairhead & Bretagnon 1990 leading terms: (amplitude [s],
# frequency [rad / Julian millennium], phase [rad]); t in TT millennia
# since J2000. Constant-in-t group:
_FB_T0 = np.array([
    (1.656674564e-3, 6283.075849991, 6.240054195),
    (2.2417471e-5, 5753.384884897, 4.296977442),
    (1.3839792e-5, 12566.151699983, 6.196904410),
    (4.770086e-6, 529.690965095, 0.444401603),
    (4.676740e-6, 6069.776754553, 4.021195093),
    (2.256707e-6, 213.299095438, 5.543113262),
    (1.694205e-6, -3.523118349, 5.025132748),
    (1.554905e-6, 77713.771467920, 5.198467090),
    (1.276839e-6, 7860.419392439, 5.988822341),
    (1.193379e-6, 5223.693919802, 3.649823730),
    (1.115322e-6, 3930.209696220, 1.422745069),
    (0.794185e-6, 11506.769769794, 2.322313077),
    (0.600309e-6, 1577.343542448, 2.678271909),
    (0.496817e-6, 6208.294251424, 5.696701824),
    (0.486306e-6, 5884.926846583, 0.520007179),
    (0.468597e-6, 6244.942814354, 5.866398759),
    (0.447061e-6, 26.298319800, 3.615796498),
    (0.435206e-6, -398.149003408, 4.349338347),
    (0.432392e-6, 74.781598567, 2.435898309),
    (0.375510e-6, 5507.553238667, 4.103476804),
    (0.243085e-6, -775.522611324, 3.651837925),
    (0.230685e-6, 5856.477659115, 4.773852582),
    (0.203747e-6, 12036.460734888, 4.333987818),
    (0.173435e-6, 18849.227549974, 6.153743485),
    (0.159080e-6, 10977.078804699, 1.890075226),
    (0.143935e-6, -796.298006816, 5.957517795),
    (0.137927e-6, 11790.629088659, 1.135934669),
    (0.119979e-6, 38.133035638, 4.551585768),
    (0.118971e-6, 5486.777843175, 1.914547226),
    (0.116120e-6, 1059.381930189, 0.873504123),
    # terms 31-60 of the published t^0 table
    # (amplitudes 0.028-0.102 us)
    (0.101868e-6, -5573.142801634, 5.984503847),
    (0.098358e-6, 2352.866153772, 6.145309371),
    (0.080164e-6, 206.185548437, 2.095377709),
    (0.079645e-6, 4694.002954708, 2.949233637),
    (0.075019e-6, 2942.463423292, 4.980931759),
    (0.064397e-6, 5746.271337896, 1.280308748),
    (0.063814e-6, 5760.498431898, 4.167901731),
    (0.062617e-6, 20.775395492, 2.654394814),
    (0.058844e-6, 426.598190876, 4.839650148),
    (0.054139e-6, 17260.154654690, 3.411091093),
    (0.048373e-6, 155.420399434, 2.251573730),
    (0.048042e-6, 2146.165416475, 1.495846011),
    (0.046551e-6, -0.980321068, 0.921573539),
    (0.042732e-6, 632.783739313, 5.720622217),
    (0.042560e-6, 161000.685737473, 1.270837679),
    (0.042411e-6, 6275.962302991, 2.869567043),
    (0.040759e-6, 12352.852604545, 3.981496998),
    (0.040480e-6, 15720.838784878, 2.546610123),
    (0.040184e-6, -7.113547001, 3.565975565),
    (0.036955e-6, 3154.687084896, 5.071801441),
    (0.036564e-6, 5088.628839767, 3.324679049),
    (0.036507e-6, 801.820931124, 6.248866009),
    (0.034867e-6, 522.577418094, 5.210064075),
    (0.033529e-6, 9437.762934887, 2.404714239),
    (0.033477e-6, 6062.663207553, 4.144987272),
    (0.032438e-6, 6076.890301554, 0.749317412),
    (0.032423e-6, 8827.390269875, 5.541473556),
    (0.030215e-6, 7084.896781115, 3.389610345),
    (0.029247e-6, -71430.695617928, 4.183178762),
    (0.028244e-6, -6286.598968340, 5.069663519),
])
# t^1 group (16 leading terms):
_FB_T1 = np.array([
    (102.156724e-6, 6283.075849991, 4.249032005),
    (1.706807e-6, 12566.151699983, 4.205904248),
    (0.269668e-6, 213.299095438, 3.400290479),
    (0.265919e-6, 529.690965095, 5.836047367),
    (0.210568e-6, -3.523118349, 6.262738348),
    (0.077996e-6, 5223.693919802, 4.670344204),
    (0.059641e-6, 26.298319800, 1.083044735),
    (0.054764e-6, 1577.343542448, 4.534800170),
    (0.034420e-6, -398.149003408, 5.980077351),
    (0.033595e-6, 5507.553238667, 5.980162321),
    (0.032088e-6, 18849.227549974, 5.869584648),
    (0.029198e-6, 5856.477659115, 0.313144238),
    (0.027764e-6, 155.420399434, 0.419288904),
    (0.025190e-6, 5746.271337896, 2.776244623),
    (0.024976e-6, 5760.498431898, 2.689294301),
    (0.022997e-6, -796.298006816, 1.255488919),
])
# t^2 group:
_FB_T2 = np.array([
    (4.322990e-6, 6283.075849991, 2.642893748),
    (0.406495e-6, 0.0, 4.712388980),
    (0.122605e-6, 12566.151699983, 2.438140634),
    (0.019476e-6, 213.299095438, 1.642186981),
    (0.016916e-6, 529.690965095, 4.510959344),
    (0.013374e-6, -3.523118349, 1.502210314),
])
# t^3 leading term:
_FB_T3 = np.array([
    (0.143388e-6, 6283.075849991, 1.131453581),
])


def utc_mjd_to_tt_mjd(day, frac):
    """Pulsar-MJD UTC (int day f64, frac dd) → TT as one dd MJD.

    TT = UTC + (TAI−UTC)(utc day) + 32.184 s. The pulsar-MJD convention
    makes the day fraction elapsed/86400 even on 86401-s days, so the
    offset addition is uniform (this is precisely why the convention
    exists — reference: src/pint/pulsar_mjd.py).
    """
    day = np.asarray(day, np.float64)
    off = tai_minus_utc(day) + TT_MINUS_TAI  # seconds
    mjd = dd_np.add_f(frac, day)
    return dd_np.add(mjd, dd_np.div_f(dd_np.dd(off), SECS_PER_DAY))


def tt_mjd_to_utc_mjd(day, frac):
    """TT (f64 day, f64 frac) -> pulsar-MJD UTC (day, frac), both f64
    pairs normalized to frac in [0, 1). Inverse of utc_mjd_to_tt_mjd.

    The leap table must be evaluated at the UTC day the answer lands
    on, which is itself the answer — a fixed point of the staircase
    map d -> day + floor(frac - off(d)). Two iterations reach it
    everywhere except inside an inserted leap second (23:59:60.x has
    no pulsar-MJD preimage; the iteration 2-cycles across the step):
    those instants alias to the start of the following day, matching
    the convention's elapsed/86400 aliasing, as does an exact
    post-step midnight that lands one ulp short (the bug the
    precision-fuzz leap sweep caught: the old two-pass returned a UTC
    a full second late there)."""
    day = np.asarray(day, np.float64)
    frac = np.asarray(frac, np.float64)

    def off_of(d):
        return (tai_minus_utc(d) + TT_MINUS_TAI) / SECS_PER_DAY

    d1 = day + np.floor(frac - off_of(day))
    d2 = day + np.floor(frac - off_of(d1))
    d3 = day + np.floor(frac - off_of(d2))
    # converged lanes have d3 == d2; 2-cycling lanes (inside a leap
    # second) take the later day — both are just the max
    day_utc = np.maximum(d2, d3)
    f = frac - off_of(day_utc) - (day_utc - day)
    f = np.clip(f, 0.0, np.nextafter(1.0, 0.0))
    return day_utc, f


def tdb_minus_tt_seconds(tt_mjd_f64):
    """Truncated Fairhead–Bretagnon TDB−TT [s] at TT MJD(s) (f64 is ample:
    the series slope is ~1e-7 s/s, so µs-level argument error is harmless).
    w = Σ_k t^k Σ_i A_ki sin(ω_ki t + φ_ki), t in TT millennia.
    """
    t = (np.asarray(tt_mjd_f64, np.float64) - MJD_J2000) / 365250.0
    w = np.zeros_like(t)
    tk = np.ones_like(t)
    for table in (_FB_T0, _FB_T1, _FB_T2, _FB_T3):
        g = np.zeros_like(t)
        for A, om, ph in table:
            g = g + A * np.sin(om * t + ph)
        w = w + tk * g
        tk = tk * t
    return w


def tt_mjd_to_tdb_mjd(tt_mjd):
    """TT dd MJD → TDB dd MJD (geocentric term only)."""
    dtdb = tdb_minus_tt_seconds(dd_np.to_f64(tt_mjd))
    return dd_np.add(tt_mjd, dd_np.div_f(dd_np.dd(dtdb), SECS_PER_DAY))
