"""Leap-second (TAI−UTC) table, embedded — this build environment has no
network and no astropy/erfa to consult (reference equivalent: ERFA ``dat``
via astropy.time; SURVEY.md Appendix A.2).

TAI−UTC = 10 s at 1972-01-01, +1 s after each listed UTC day; 37 s from
2017-01-01 onward (no leap second scheduled through 2026).
"""

from __future__ import annotations

import numpy as np

# MJD of 00:00 UTC on the day AFTER each leap second (i.e., the instant the
# new offset takes effect), and the TAI-UTC value from that instant.
_LEAP_MJDS = [
    (41317.0, 10.0),  # 1972-01-01 baseline
    (41499.0, 11.0),  # 1972-07-01
    (41683.0, 12.0),  # 1973-01-01
    (42048.0, 13.0),  # 1974-01-01
    (42413.0, 14.0),  # 1975-01-01
    (42778.0, 15.0),  # 1976-01-01
    (43144.0, 16.0),  # 1977-01-01
    (43509.0, 17.0),  # 1978-01-01
    (43874.0, 18.0),  # 1979-01-01
    (44239.0, 19.0),  # 1980-01-01
    (44786.0, 20.0),  # 1981-07-01
    (45151.0, 21.0),  # 1982-07-01
    (45516.0, 22.0),  # 1983-07-01
    (46247.0, 23.0),  # 1985-07-01
    (47161.0, 24.0),  # 1988-01-01
    (47892.0, 25.0),  # 1990-01-01
    (48257.0, 26.0),  # 1991-01-01
    (48804.0, 27.0),  # 1992-07-01
    (49169.0, 28.0),  # 1993-07-01
    (49534.0, 29.0),  # 1994-07-01
    (50083.0, 30.0),  # 1996-01-01
    (50630.0, 31.0),  # 1997-07-01
    (51179.0, 32.0),  # 1999-01-01
    (53736.0, 33.0),  # 2006-01-01
    (54832.0, 34.0),  # 2009-01-01
    (56109.0, 35.0),  # 2012-07-01
    (57204.0, 36.0),  # 2015-07-01
    (57754.0, 37.0),  # 2017-01-01
]

_MJDS = np.array([m for m, _ in _LEAP_MJDS])
_OFFS = np.array([o for _, o in _LEAP_MJDS])


def leap_table():
    """(effective_mjd_utc, tai_minus_utc_seconds) arrays."""
    return _MJDS.copy(), _OFFS.copy()


def tai_minus_utc(mjd_utc):
    """TAI−UTC in seconds for UTC MJD(s); 10 s before 1972 is extended
    backwards (pre-1972 rubber-second UTC is out of scope, as in the
    reference's pulsar use)."""
    mjd_utc = np.asarray(mjd_utc, dtype=np.float64)
    idx = np.searchsorted(_MJDS, mjd_utc, side="right") - 1
    idx = np.clip(idx, 0, len(_OFFS) - 1)
    return _OFFS[idx]


def is_leap_second_day(mjd_int):
    """True for UTC days that contain a leap second (86401 s) — the day
    *before* each entry above (after the 1972 baseline)."""
    mjd_int = np.asarray(mjd_int)
    return np.isin(mjd_int + 1, _MJDS[1:].astype(np.int64))
