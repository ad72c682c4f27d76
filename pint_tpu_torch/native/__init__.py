"""Native (C++) host kernels, loaded with ctypes (a port of
pint_tpu/native).

They speed up the host runtime around the device path, in the role
astropy's fast C time parser plays for the reference. The source,
``pint_tpu_torch/csrc/mjdparse.cpp``, is compiled by ``g++`` on first use
into ``build/`` beside the package, keyed on a hash of the source and the
flags; importing this module builds nothing. Every native kernel has a
pure-Python twin that gives bit-identical results, so a missing compiler
costs only speed: the build warns and ``mjdparse_native`` returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["mjdparse_native", "native_available", "build"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "mjdparse.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -ffp-contract=off: FMA contraction would break the bit-identical
# contract with the Python parser, which has no fused multiply-add
_FLAGS = ["-O2", "-ffp-contract=off", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"mjdparse-{key[:16]}.so"


def build() -> Path:
    """Compile the parser into build/ unless a library built from this
    exact source and these flags is already there. Returns its path;
    raises OSError or subprocess.SubprocessError when g++ fails."""
    so = _path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic when processes build at once
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"native mjdparse unavailable ({e}); using the "
                      "pure-Python parser")
        return None
    lib.parse_mjd_batch.restype = ctypes.c_longlong
    lib.parse_mjd_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the native parser builds (or is built) and loads."""
    return _load() is not None


def mjdparse_native(strings):
    """Batch-parse decimal MJD strings natively: (days, (fhi, flo)), or
    None when the native parser is unavailable. Raises ValueError on a
    malformed string, as the Python parser does."""
    lib = _load()
    if lib is None:
        return None
    n = len(strings)
    enc = []
    for s in strings:
        if "\x00" in s:
            raise ValueError(f"bad MJD string {s!r}")
        enc.append(s.encode("ascii", "replace"))
    offs = np.empty(n, dtype=np.int64)
    pos = 0
    for i, b in enumerate(enc):
        offs[i] = pos
        pos += len(b) + 1
    buf = b"\x00".join(enc) + b"\x00"
    day = np.empty(n)
    fhi = np.empty(n)
    flo = np.empty(n)
    bad = lib.parse_mjd_batch(buf, offs, n, day, fhi, flo)
    if bad >= 0:
        raise ValueError(f"bad MJD string {strings[bad]!r}")
    return day, (fhi, flo)
