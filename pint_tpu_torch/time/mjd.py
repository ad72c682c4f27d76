"""High-precision MJD handling: decimal-string ↔ double-double, and the
"pulsar MJD" convention.

TOA files carry MJDs as decimal strings with up to ~19 significant digits
— far beyond f64. The reference routes these through ``np.longdouble``
(src/pint/pulsar_mjd.py); here each MJD becomes a host dd pair
(day-integer, day-fraction) that is exact to <1 ps.

The "pulsar_mjd" convention (reference: PulsarMJD astropy Time format):
observatory UTC MJDs count 86400 s/day even on leap-second days; the day
fraction is elapsed-seconds/86400 regardless. We keep TOAs in that
convention and convert to TT/TDB seconds via the leap table.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.ops import dd_np


def parse_mjd_string(s: str):
    """Parse a decimal MJD string exactly into (int_day: float, frac: dd).

    The integer day is exact in f64; the fraction is parsed as an integer
    scaled by a power of ten using two f64 legs (front/back 15-digit
    chunks), keeping <1e-19 day (≈ 10 ps) precision.
    """
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." in s:
        ip, fp = s.split(".", 1)
    else:
        ip, fp = s, ""
    if (not ip and not fp) or (ip and not ip.isdigit()) or \
            (fp and not fp.isdigit()) or len(ip) > 18:
        # isdigit() also rejects int()-tolerated junk like '1_5' or '+5'
        raise ValueError(f"bad MJD string {s!r}")
    day = float(int(ip)) if ip else 0.0
    # fraction digits → dd via chunked base-10 accumulation
    frac = dd_np.dd(0.0)
    fp = fp[:30]
    if fp:
        a = fp[:15]
        b = fp[15:30]
        frac = dd_np.div(dd_np.dd(float(int(a))), dd_np.dd(10.0 ** len(a)))
        if b:
            # divide by 10^len(b) then 10^15: both divisors exact in
            # f64 (10^k exact only to k=22), keeping the native C++
            # parser bit-identical
            fb = dd_np.div(dd_np.dd(float(int(b))),
                           dd_np.dd(10.0 ** len(b)))
            fb = dd_np.div(fb, dd_np.dd(10.0 ** 15))
            frac = dd_np.add(frac, fb)
    if neg:
        return -day, dd_np.neg(frac)
    return day, frac


def parse_mjd_strings(strings, use_native: bool = True):
    """Vector parse → (int_days f64 array, frac dd pair of arrays).
    Batches of 256 strings or more go through the native C++ parser
    when it builds (bit-identical results; pint_tpu_torch/native),
    others one string at a time through parse_mjd_string."""
    if use_native and len(strings) >= 256:
        from pint_tpu_torch.native import mjdparse_native

        out = mjdparse_native(strings)
        if out is not None:
            return out
    days = np.empty(len(strings))
    fhi = np.empty(len(strings))
    flo = np.empty(len(strings))
    for i, s in enumerate(strings):
        d, f = parse_mjd_string(s)
        days[i] = d
        fhi[i] = f[0]
        flo[i] = f[1]
    return days, (fhi, flo)


def mjd_to_str(day: float, frac, ndigits: int = 16) -> str:
    """Format (int_day, frac dd) back to a decimal MJD string, exact to
    ndigits of fraction (round-trip partner of parse_mjd_string)."""
    fhi = float(np.asarray(frac[0]))
    flo = float(np.asarray(frac[1]))
    day = int(day)
    # normalize frac into [0, 1)
    total = fhi + flo
    if total < 0:
        borrow = int(np.ceil(-total))
        day -= borrow
        fhi += borrow
    elif total >= 1.0:
        carry = int(np.floor(total))
        day += carry
        fhi -= carry
    # digit-by-digit extraction in dd
    f = dd_np.dd(fhi, flo)
    digits = []
    for _ in range(ndigits):
        f = dd_np.mul_f(f, 10.0)
        d = int(np.floor(f[0] + f[1]))
        d = min(max(d, 0), 9)
        digits.append(str(d))
        f = dd_np.sub_f(f, float(d))
    return f"{day}.{''.join(digits)}"


# MJD of the civil epoch 1970-01-01 (Unix day 0)
_MJD_UNIX_EPOCH = 40587


def mjd_to_calendar(days):
    """EXACT MJD -> civil (UTC) proleptic-Gregorian calendar:
    returns (year, month, day_of_month, day_of_year) int64 arrays
    for integer MJDs (a Julian-year 365.25 d approximation drifts
    ~0.75 d within a year and fabricates day-366 artifacts at
    non-leap year boundaries).

    Fully VECTORIZED integer arithmetic (the civil_from_days
    algorithm: 400-year eras of exactly 146097 days, year-of-era
    recovered by correcting for the 4/100/400 leap rules, months
    counted from March so the leap day lands last) — O(N) numpy
    ops, no per-element datetime calls, exact for all
    representable MJDs. Oracle: datetime itself, in
    tests/test_obs.py::test_mjd_to_calendar_exact."""
    days = np.atleast_1d(np.asarray(days))
    z = np.floor(days).astype(np.int64) - _MJD_UNIX_EPOCH + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097                              # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524
           - doe // 146096) // 365                      # [0, 399]
    y = yoe + era * 400                                 # March-based
    doy_mar = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy_mar + 2) // 153                       # [0, 11]
    dom = doy_mar - (153 * mp + 2) // 5 + 1             # [1, 31]
    month = mp + np.where(mp < 10, 3, -9)               # [1, 12]
    year = y + (month <= 2)
    # day-of-year: the same algebra inverted for Jan 1 of `year`
    # (days_from_civil(year, 1, 1)), so the leap rules can never
    # disagree with the conversion above
    yj = year - 1                                       # Jan -> m<=2
    era_j = np.floor_divide(yj, 400)
    yoe_j = yj - era_j * 400
    doy_jan1 = (153 * 10 + 2) // 5                      # Jan 1, March-based
    doe_j = yoe_j * 365 + yoe_j // 4 - yoe_j // 100 + doy_jan1
    jan1_z = era_j * 146097 + doe_j - 719468
    doy = z - 719468 - jan1_z + 1
    return year, month, dom, doy


def mjd_dd_to_seconds(day, frac, epoch_day: float):
    """(day + frac − epoch_day) in SI seconds as a dd pair (86400 s/day,
    pulsar-MJD convention — caller handles scale offsets separately)."""
    ddays = dd_np.add_f(frac, np.asarray(day, np.float64) - epoch_day)
    return dd_np.mul_f(ddays, 86400.0)
