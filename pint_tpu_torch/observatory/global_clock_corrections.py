"""Global clock-correction repository machinery.

Reference: src/pint/observatory/global_clock_corrections.py — there,
an Index file is downloaded from the IPTA pulsar-clock-corrections
repository, each clock file carries an update-interval policy, and
astropy's download cache stores copies. This build runs with ZERO
egress, so the TPU-native equivalent is mirror-based: point
$PINT_TPU_CLOCK_DIR (or ``set_clock_mirror``) at a local clone of
https://ipta.github.io/pulsar-clock-corrections/ and the same Index
semantics apply — per-file validity windows, staleness warnings, and
an ``update_clock_files`` that verifies mirror freshness instead of
fetching. Everything degrades loudly, never silently.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Index", "IndexEntry", "get_index",
           "get_clock_correction_file", "update_clock_files",
           "set_clock_mirror", "clock_mirror"]

_MIRROR: Optional[str] = None
_INDEX_CACHE: Dict[str, "Index"] = {}

#: default maximum mirror age before update_clock_files warns [days]
DEFAULT_UPDATE_INTERVAL_DAYS = 64.0


def set_clock_mirror(path: Optional[str]):
    """Point the registry at a local pulsar-clock-corrections clone
    (overrides $PINT_TPU_CLOCK_DIR for the index machinery)."""
    global _MIRROR
    _MIRROR = path
    _INDEX_CACHE.clear()
    # forget per-name miss memos AND warn-once sentinels so a
    # re-pointed mirror is re-consulted for previously-missing files
    # and a broken replacement mirror still warns loudly
    from pint_tpu_torch.observatory import clock as _clock

    _clock._refresh_missed.clear()
    _clock._warned_missing.clear()


def get_index(mirror: Optional[str] = None,
              refresh: bool = False) -> "Index":
    """Cached Index for the configured mirror (one tree walk per
    mirror per session, not per lookup); ``refresh`` forces a re-walk
    (e.g. after dropping a new file into the mirror)."""
    m = mirror or clock_mirror()
    if m is None:
        raise FileNotFoundError(
            "no clock mirror configured: set $PINT_TPU_CLOCK_DIR or "
            "call set_clock_mirror()")
    if refresh or m not in _INDEX_CACHE:
        _INDEX_CACHE[m] = Index(m)
    return _INDEX_CACHE[m]


def clock_mirror() -> Optional[str]:
    from pint_tpu_torch import config

    d = config.clock_dir()
    return _MIRROR or (str(d) if d is not None else None)


@dataclass
class IndexEntry:
    """One row of the repository index (reference: Index entries):
    file name, advertised update interval, and last-modification
    metadata from the mirror filesystem."""

    name: str
    path: str
    update_interval_days: float
    mtime: float

    @property
    def age_days(self) -> float:
        return (time.time() - self.mtime) / 86400.0

    @property
    def stale(self) -> bool:
        iv = self.update_interval_days
        return iv > 0 and self.age_days > iv


class Index:
    """Enumerate the clock files available in the local mirror
    (reference: global_clock_corrections.Index, minus the download).

    An ``index.txt`` in the mirror root — lines of
    ``<relative path> <update interval days>`` — is honored when
    present; otherwise every ``*.clk``/``time*.dat`` under the mirror
    is indexed with the default update interval."""

    def __init__(self, mirror: Optional[str] = None):
        mirror = mirror or clock_mirror()
        if mirror is None:
            raise FileNotFoundError(
                "no clock mirror configured: set $PINT_TPU_CLOCK_DIR "
                "or call set_clock_mirror() with a local clone of the "
                "pulsar-clock-corrections repository (this build has "
                "no network access, so nothing can be downloaded)")
        if not os.path.isdir(mirror):
            raise FileNotFoundError(
                f"clock mirror {mirror!r} is not a directory")
        self.mirror = mirror
        self.files: Dict[str, IndexEntry] = {}
        index_txt = os.path.join(mirror, "index.txt")
        if os.path.exists(index_txt):
            with open(index_txt) as fh:
                for line in fh:
                    line = line.split("#", 1)[0].strip()
                    if not line:
                        continue
                    toks = line.split()
                    rel = toks[0]
                    iv = float(toks[1]) if len(toks) > 1 else \
                        DEFAULT_UPDATE_INTERVAL_DAYS
                    full = os.path.join(mirror, rel)
                    if os.path.exists(full):
                        self._add(rel, full, iv)
                    else:
                        warnings.warn(
                            f"index.txt lists {rel!r} but the mirror "
                            "lacks it")
        else:
            for root, _, names in os.walk(mirror):
                for nm in sorted(names):
                    if nm.endswith(".clk") or (
                            nm.startswith("time") and
                            nm.endswith(".dat")):
                        full = os.path.join(root, nm)
                        rel = os.path.relpath(full, mirror)
                        self._add(rel, full,
                                  DEFAULT_UPDATE_INTERVAL_DAYS)

    def _add(self, rel: str, full: str, iv: float):
        base = os.path.basename(rel)
        prev = self.files.get(base)
        if prev is not None and \
                os.path.abspath(prev.path) != os.path.abspath(full):
            warnings.warn(
                f"clock mirror has two files named {base!r} "
                f"({prev.path} and {full}); keeping the first — "
                "remove the duplicate or use an index.txt")
            return
        self.files[base] = IndexEntry(
            name=base, path=full, update_interval_days=iv,
            mtime=os.path.getmtime(full))

    def __contains__(self, name: str) -> bool:
        return os.path.basename(name) in self.files

    def __getitem__(self, name: str) -> IndexEntry:
        return self.files[os.path.basename(name)]


def get_clock_correction_file(name: str, limits: str = "warn",
                              index: Optional[Index] = None) -> str:
    """Path of ``name`` in the mirror (reference:
    get_clock_correction_file, download replaced by mirror lookup).
    Stale files warn (or raise with limits='error')."""
    idx = index or get_index()
    if name not in idx:
        raise FileNotFoundError(
            f"clock file {name!r} not in the mirror at "
            f"{idx.mirror!r} ({len(idx.files)} files indexed)")
    entry = idx[name]
    if entry.stale:
        msg = (f"clock file {name!r} is {entry.age_days:.0f} days old "
               f"(update interval {entry.update_interval_days:.0f} d);"
               " refresh the mirror clone")
        if limits == "error":
            raise RuntimeError(msg)
        warnings.warn(msg)
    return entry.path


def update_clock_files(names: Optional[List[str]] = None,
                       limits: str = "warn",
                       index: Optional[Index] = None) -> Dict[str, bool]:
    """Freshness report for every (or the named) mirror clock file
    (reference: update_clock_files — with zero egress this verifies
    instead of fetching). Returns {name: is_fresh}; stale entries warn
    or raise per ``limits``."""
    idx = index or get_index()
    wanted = names if names is not None else sorted(idx.files)
    out: Dict[str, bool] = {}
    stale = []
    for nm in wanted:
        if nm not in idx:
            raise FileNotFoundError(
                f"clock file {nm!r} not in the mirror")
        e = idx[nm]
        out[nm] = not e.stale
        if e.stale:
            stale.append(f"{nm} ({e.age_days:.0f} d old)")
    if stale:
        msg = ("stale clock files (no network in this build — refresh "
               f"the mirror clone): {', '.join(stale)}")
        if limits == "error":
            raise RuntimeError(msg)
        warnings.warn(msg)
    return out
