"""Earth-orientation-parameter (EOP) table loading.

The reference gets dUT1/polar motion from IERS tables that astropy
downloads at runtime (reference: src/pint/erfautils.py consuming
astropy.utils.iers). This build is zero-egress, so EOP arrives the same
way clock corrections do: from a local mirror directory
($PINT_TPU_CLOCK_DIR, see observatory/global_clock_corrections) that
the operator syncs out-of-band. Two formats:

- IERS ``finals2000A.all`` / ``finals.all`` fixed-width records (the
  file astropy's IERS-A machinery consumes): MJD at columns 8-15,
  polar motion x/y [arcsec] at 19-27 / 38-46, UT1-UTC [s] at 59-68.
- A plain whitespace table ``# MJD xp_arcsec yp_arcsec dut1_s`` for
  hand-maintained mirrors.

``install_eop`` feeds the parsed table into time.frames.set_eop, after
which itrf_to_gcrs_posvel applies UT1 = UTC + dUT1 and polar motion.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["parse_finals2000a", "parse_plain_eop", "load_eop_file",
           "find_eop_file", "install_eop"]

_FINALS_NAMES = ("finals2000A.all", "finals.all", "finals2000A.data",
                 "finals.data", "eop.dat")


def parse_finals2000a(text: str):
    """Parse IERS finals2000A fixed-width records →
    (mjd, xp_arcsec, yp_arcsec, dut1_s) arrays. Records without a
    UT1-UTC value (future epochs beyond prediction) are dropped."""
    mjd, xp, yp, dut1 = [], [], [], []
    for line in text.splitlines():
        if len(line) < 68:
            continue
        try:
            m = float(line[7:15])
            x = float(line[18:27])
            y = float(line[37:46])
            d = float(line[58:68])
        except ValueError:
            continue
        # sanity windows: |PM| < 1 arcsec, |dUT1| < 0.9 s by definition
        if not (0 < m < 1e5 and abs(x) < 2 and abs(y) < 2
                and abs(d) < 1.0):
            continue
        mjd.append(m)
        xp.append(x)
        yp.append(y)
        dut1.append(d)
    return (np.asarray(mjd), np.asarray(xp), np.asarray(yp),
            np.asarray(dut1))


def parse_plain_eop(text: str):
    """Parse the plain-table format: ``MJD xp_arcsec yp_arcsec dut1_s``
    per line, ``#`` comments."""
    mjd, xp, yp, dut1 = [], [], [], []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 4:
            continue
        try:
            vals = [float(v) for v in parts[:4]]
        except ValueError:
            continue
        mjd.append(vals[0])
        xp.append(vals[1])
        yp.append(vals[2])
        dut1.append(vals[3])
    return (np.asarray(mjd), np.asarray(xp), np.asarray(yp),
            np.asarray(dut1))


def load_eop_file(path: str):
    """(mjd, xp_arcsec, yp_arcsec, dut1_s) from either supported
    format (finals fixed-width tried first — its lines are full-width
    so plain parsing of one would not yield 4 clean floats)."""
    with open(path) as f:
        text = f.read()
    out = parse_finals2000a(text)
    if len(out[0]) == 0:
        out = parse_plain_eop(text)
    if len(out[0]) == 0:
        raise ValueError(f"no EOP records parsed from {path}")
    return out


def find_eop_file(mirror_dir: Optional[str] = None) -> Optional[str]:
    """Locate an EOP table in the clock-mirror directory (searched at
    the top level and under ``T2runtime/earth/``, where tempo2-style
    mirrors keep orientation data)."""
    if mirror_dir is None:
        from pint_tpu_torch.observatory.global_clock_corrections import \
            clock_mirror

        mirror_dir = clock_mirror()
    if not mirror_dir:
        return None
    for sub in ("", "earth", os.path.join("T2runtime", "earth")):
        d = os.path.join(mirror_dir, sub) if sub else mirror_dir
        if not os.path.isdir(d):
            continue
        for name in _FINALS_NAMES:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                return p
    return None


def install_eop(path: Optional[str] = None) -> Tuple[int, str]:
    """Load an EOP table (explicit path, else the mirror search) and
    install it via frames.set_eop. Returns (n_records, path)."""
    from pint_tpu_torch.time import frames

    if path is None:
        path = find_eop_file()
        if path is None:
            raise FileNotFoundError(
                "no EOP table found: set $PINT_TPU_CLOCK_DIR at a "
                "mirror containing finals2000A.all (or pass a path)")
    mjd, xp, yp, dut1 = load_eop_file(path)
    frames.set_eop(mjd, dut1, xp_arcsec=xp, yp_arcsec=yp)
    return len(mjd), path
