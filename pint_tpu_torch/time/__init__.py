"""Time scales, Earth orientation, and high-precision MJD handling.

This package replaces what the reference gets from astropy.time + PyERFA
(C) — see SURVEY.md §2b: UTC/TAI/TT/TDB scale chains, the "pulsar MJD"
convention, Earth rotation (ERA/GMST), precession-nutation, and
ITRF→GCRS observatory position/velocity
(reference: src/pint/pulsar_mjd.py, src/pint/erfautils.py).

Everything here is host-side numpy (IEEE f64 + double-double pairs);
results are packed into device arrays once per dataset (the host/device
cut described in ARCHITECTURE.md).
"""

from pint_tpu_torch.time.leapseconds import tai_minus_utc, leap_table  # noqa: F401
from pint_tpu_torch.time.mjd import (  # noqa: F401
    parse_mjd_string,
    mjd_to_str,
    mjd_dd_to_seconds,
)
from pint_tpu_torch.time.scales import (  # noqa: F401
    utc_mjd_to_tt_mjd,
    tt_mjd_to_tdb_mjd,
    tdb_minus_tt_seconds,
)
from pint_tpu_torch.time.frames import (  # noqa: F401
    earth_rotation_angle,
    gmst06,
    obliquity06,
    nutation00b_truncated,
    precession_matrix,
    itrf_to_gcrs_posvel,
    icrs_to_ecliptic_matrix,
)
