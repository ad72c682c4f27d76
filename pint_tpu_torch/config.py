"""Runtime settings (a copy of the functions of pint_tpu/config.py that
the port calls).

- $PINT_TPU_CLOCK_DIR     : directory of TEMPO/TEMPO2 clock files
- $PINT_TPU_EPHEM_DIR     : directory of SPK .bsp ephemeris kernels
- $PINT_TPU_OBS_OVERRIDE  : JSON file overriding the observatory table
- $PINT_TPU_STREAM_MIN_TOA: TOA count from which Fitter.auto streams
- $PINT_TPU_STREAM_CHUNK  : chunk length of the streaming accumulator
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

__all__ = ["clock_dir", "ephem_dir", "obs_override", "solve_streaming",
           "stream_chunk"]

log = logging.getLogger(__name__)
_WARNED_ENV: set = set()


def clock_dir() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_CLOCK_DIR")
    return Path(d) if d else None


def ephem_dir() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_EPHEM_DIR")
    return Path(d) if d else None


def obs_override() -> Optional[Path]:
    d = os.environ.get("PINT_TPU_OBS_OVERRIDE")
    return Path(d) if d else None


def _warn_once(name: str, why: str, raw: str, fallback) -> None:
    if (name, why, raw) not in _WARNED_ENV:
        _WARNED_ENV.add((name, why, raw))
        log.warning("$%s=%r %s; using %r", name, raw, why, fallback)


def _env_int(name: str, default, shown=None):
    """A numeric environment override, or ``default`` when it is unset;
    an unparsable value warns once (naming ``shown``, the default by
    default) and gives ``default``."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        _warn_once(name, "is not a number", raw,
                   default if shown is None else shown)
        return default


def solve_streaming() -> int:
    """TOA count from which ``Fitter.auto`` picks the matrix-free
    streaming GLS (``parallel.streaming``) over the dense fitters
    ($PINT_TPU_STREAM_MIN_TOA; 0 turns the route off). Default 200,000:
    above the largest dense shape the reference validated (131,072
    TOAs) and below where the dense (N, p+q) whitened design stops
    being a sane device allocation. A negative value warns once and
    gives the default."""
    v = _env_int("PINT_TPU_STREAM_MIN_TOA", 200_000)
    if v < 0:
        _warn_once("PINT_TPU_STREAM_MIN_TOA", "is negative",
                   os.environ.get("PINT_TPU_STREAM_MIN_TOA"), 200_000)
        return 200_000
    return v


def stream_chunk(ntoa: int) -> int:
    """Chunk length of the streaming accumulator for an ``ntoa``-TOA fit
    ($PINT_TPU_STREAM_CHUNK), a power of two: the smallest one >= ntoa/8
    in [4096, 65536] (at least 8 chunks keeps the last chunk's padding
    under 12.5 %; the cap bounds the (chunk, p+q) working set). A set
    value is rounded up to a power of two in [256, 131072]; one that is
    not a positive integer warns once and gives the default."""
    v = _env_int("PINT_TPU_STREAM_CHUNK", None, "the auto size")
    if v is not None:
        if v > 0:
            k = 256
            while k < v and k < 131072:
                k *= 2
            return k
        _warn_once("PINT_TPU_STREAM_CHUNK", "is not a positive chunk length",
                   os.environ.get("PINT_TPU_STREAM_CHUNK"), "the auto size")
    k = 4096
    target = -(-int(ntoa) // 8)
    while k < target and k < 65536:
        k *= 2
    return k
