"""Clock-correction files: TEMPO and TEMPO2 formats, MJD interpolation.

Reference: src/pint/observatory/clock_file.py (ClockFile). This offline
build ships no correction data (the reference downloads the IPTA
pulsar-clock-corrections repo at runtime — impossible here, zero egress);
the default chain is therefore zero-correction with a single loud
warning, but the parser/evaluator machinery is complete so real files
drop in via $PINT_TPU_CLOCK_DIR.

Formats:
- TEMPO2 ``*.clk``: header line ``# <from> <to> [badness]``, then rows
  ``mjd offset_s [flags]``.
- TEMPO ``time*.dat``: rows ``mjd offset_us ...``; lines starting with
  a comment char ignored; an ``@``/``&`` in column 0 marks epoch resets
  (treated as plain rows here).
"""

from __future__ import annotations

import os
import warnings

import numpy as np


class ClockFile:
    """MJD → clock offset (seconds), linear interpolation, with
    out-of-range policy matching the reference: warn and hold the last
    value past the end of the table."""

    def __init__(self, mjd, offset_s, name="clock", valid_beyond_end=False):
        self.mjd = np.asarray(mjd, np.float64)
        self.offset_s = np.asarray(offset_s, np.float64)
        self.name = name
        self.valid_beyond_end = valid_beyond_end
        if self.mjd.size and np.any(np.diff(self.mjd) < 0):
            order = np.argsort(self.mjd)
            self.mjd = self.mjd[order]
            self.offset_s = self.offset_s[order]

    @classmethod
    def read_tempo2(cls, path):
        mjds, offs = [], []
        name = os.path.basename(path)
        with open(path) as f:
            for line in f:
                s = line.strip()
                if not s or s.startswith("#"):
                    continue
                parts = s.split()
                if len(parts) < 2:
                    continue
                try:
                    mjds.append(float(parts[0]))
                    offs.append(float(parts[1]))
                except ValueError:
                    continue
        return cls(mjds, offs, name=name)

    @classmethod
    def read_tempo(cls, path):
        """TEMPO time*.dat: offsets are in microseconds."""
        mjds, offs = [], []
        name = os.path.basename(path)
        with open(path) as f:
            for line in f:
                if line.startswith(("#", "*", "C ")):
                    continue
                s = line.strip().lstrip("@&").strip()
                parts = s.split()
                if len(parts) < 2:
                    continue
                try:
                    mjds.append(float(parts[0]))
                    offs.append(float(parts[1]) * 1e-6)
                except ValueError:
                    continue
        return cls(mjds, offs, name=name)

    @classmethod
    def read(cls, path, fmt=None):
        if fmt is None:
            fmt = "tempo2" if path.endswith(".clk") else "tempo"
        return cls.read_tempo2(path) if fmt == "tempo2" \
            else cls.read_tempo(path)

    def evaluate(self, mjd, limits="warn"):
        mjd = np.asarray(mjd, np.float64)
        if self.mjd.size == 0:
            return np.zeros_like(mjd)
        lo, hi = self.mjd[0], self.mjd[-1]
        out_of_range = (mjd < lo) | (mjd > hi)
        if np.any(out_of_range) and not self.valid_beyond_end:
            msg = (f"clock file {self.name}: {int(out_of_range.sum())} "
                   f"MJD(s) outside [{lo:.1f}, {hi:.1f}]; holding edge value")
            if limits == "error":
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
        return np.interp(mjd, self.mjd, self.offset_s)


class ZeroClockFile(ClockFile):
    """The zero-correction fallback used when no clock data is on disk."""

    def __init__(self, name="zero"):
        super().__init__([], [], name=name, valid_beyond_end=True)

    def evaluate(self, mjd, limits="warn"):
        return np.zeros_like(np.asarray(mjd, np.float64))


_warned_missing = set()
_refresh_missed = set()  # names already refresh-walked and not found
_clock_cache: dict = {}


def find_clock_file(name, fmt="tempo2"):
    """Locate `name` in the clock mirror (flat file under
    $PINT_TPU_CLOCK_DIR, or anywhere inside a nested
    pulsar-clock-corrections clone via the global-corrections Index);
    zero-fallback otherwise, warning once per file name (mirrors the
    reference's missing-clock warning policy in
    src/pint/observatory/topo_obs.py). Parsed files are cached per
    (path, fmt)."""
    from pint_tpu_torch.observatory.global_clock_corrections import (
        clock_mirror, get_index)

    clock_dir = clock_mirror()
    if clock_dir:
        cand = os.path.join(clock_dir, name)
        if not os.path.exists(cand):
            # nested mirror layout (T2runtime/clock/...): consult the
            # repository index; on a miss, refresh ONCE PER NAME in
            # case the file landed after the cached walk (a hot
            # ingestion loop must not re-walk the mirror per lookup).
            # A broken mirror degrades to the zero fallback below —
            # loudly, once — never crashing ingestion
            try:
                idx = get_index()
                if name not in idx and name not in _refresh_missed:
                    _refresh_missed.add(name)
                    idx = get_index(refresh=True)
                if name in idx:
                    cand = idx[name].path
            except FileNotFoundError:
                pass
            except Exception as e:
                if "mirror-index" not in _warned_missing:
                    _warned_missing.add("mirror-index")
                    warnings.warn(
                        f"clock mirror index unusable ({e}); "
                        "falling back", stacklevel=2)
        if os.path.exists(cand):
            key = (os.path.abspath(cand), fmt)
            if key not in _clock_cache:
                _clock_cache[key] = ClockFile.read(cand, fmt=fmt)
            return _clock_cache[key]
    if name not in _warned_missing:
        _warned_missing.add(name)
        warnings.warn(
            f"no clock file {name!r} available (offline build); using "
            "zero corrections — timing vs real observatory data will be "
            "off by the site clock offset (~us). Set $PINT_TPU_CLOCK_DIR "
            "to a directory of .clk files for real-data work.",
            stacklevel=2,
        )
    return ZeroClockFile(name=name)
