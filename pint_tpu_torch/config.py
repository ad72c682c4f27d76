"""Runtime settings (a copy of the functions of pint_tpu/config.py that
the port calls).

- $PINT_TPU_CLOCK_DIR     : directory of TEMPO/TEMPO2 clock files
- $PINT_TPU_EPHEM_DIR     : directory of SPK .bsp ephemeris kernels
- $PINT_TPU_OBS_OVERRIDE  : JSON file overriding the observatory table
- $PINT_TPU_STREAM_MIN_TOA: TOA count from which Fitter.auto streams
- $PINT_TPU_STREAM_CHUNK  : chunk length of the streaming accumulator
- $PINT_TPU_CHAIN_CHUNK   : MCMC steps a chain chunk runs
- $PINT_TPU_GWB_CHUNK     : GWB grid points a sweep chunk evaluates
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

__all__ = ["chain_chunk_steps", "clock_dir", "energy_draw_chunk",
           "ephem_dir", "grid_chunk", "gwb_chunk", "obs_override",
           "photon_walker_chunk", "solve_streaming", "stream_chunk"]

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


def chain_chunk_steps(nsteps: int, thin: int = 1) -> int:
    """MCMC steps one chain chunk runs (``pint_tpu_torch.sampling``): the
    smallest power of two covering ``nsteps``, clamped to [16, 256] and
    rounded up to a multiple of ``thin``. The chain's random draws are
    positional, so the chunk length changes no result; it bounds a
    chunk's working set and how often a long chain reports progress.
    $PINT_TPU_CHAIN_CHUNK pins it (still rounded to a thin multiple)."""
    env = _env_int("PINT_TPU_CHAIN_CHUNK", None, "the auto size")
    if env is not None:
        k = max(1, int(env))
    else:
        k = 16
        while k < int(nsteps) and k < 256:
            k *= 2
    thin = max(1, int(thin))
    return ((k + thin - 1) // thin) * thin


def gwb_chunk() -> int:
    """(log10_A, gamma) grid points one GWB sweep chunk evaluates
    (``pint_tpu_torch.pta.gwb``): a power of two in [1, 64], default 8.
    The chunk's points are factored as one batch of (Npsr*m)^2 outer
    systems. $PINT_TPU_GWB_CHUNK pins it, rounded UP to a power of two;
    a value outside [1, 64] warns once and gives 8."""
    k = _env_int("PINT_TPU_GWB_CHUNK", None, 8)
    if k is None:
        return 8
    if k < 1 or k > 64:
        _warn_once("PINT_TPU_GWB_CHUNK", "is outside [1, 64]",
                   os.environ.get("PINT_TPU_GWB_CHUNK"), 8)
        return 8
    return 1 << (k - 1).bit_length()


# the chi2 grid's working set a node: float64 (N, p) blocks alive at
# once in the vmapped refit step (measured ~16 on an H100: 393 MiB for 8
# nodes at 10,000 TOAs and 39 columns, PERF.md; 24 leaves room), and
# the budget of a chunk
GRID_BLOCKS_PER_NODE = 24
GRID_BUDGET_BYTES = 2 << 30


def grid_chunk(ntoa: int, nparams: int) -> int:
    """chi2-grid nodes one vmapped refit evaluates (``pint_tpu_torch.
    gridutils``): the largest power of two in [1, 64] whose working set,
    GRID_BLOCKS_PER_NODE float64 (ntoa, nparams) blocks a node, fits
    GRID_BUDGET_BYTES (2 GiB). The result does not depend on the chunk."""
    per_node = GRID_BLOCKS_PER_NODE * 8 * max(1, int(ntoa)) \
        * max(1, int(nparams))
    k = 1
    while k < 64 and 2 * k * per_node <= GRID_BUDGET_BYTES:
        k *= 2
    return k


# the photon likelihood's working set a walker: float64 (N,) blocks alive
# at once in the vmapped dd phase chain and Gaussian template pdf
# (measured 24 on an H100: 3,072 MiB for 16 walkers at 1,048,576
# photons, PERF.md; 32 leaves room), and the budget of a chunk of walkers
PHOTON_BLOCKS_PER_WALKER = 32
PHOTON_BUDGET_BYTES = 8 << 30


def photon_walker_chunk(nphotons: int) -> int:
    """Walkers one vmapped photon-likelihood call evaluates
    (``mcmc_fitter.PhotonMCMCFitter``): the largest count whose working
    set, PHOTON_BLOCKS_PER_WALKER float64 (nphotons,) blocks a walker,
    fits PHOTON_BUDGET_BYTES (8 GiB), and at least 2 (a single row would
    take another reduction order on the CPU). The result does not depend
    on the chunk."""
    per_walker = PHOTON_BLOCKS_PER_WALKER * 8 * max(1, int(nphotons))
    return max(2, PHOTON_BUDGET_BYTES // per_walker)


# LCEnergyTemplate.random's working set a (photon, grid node) pair:
# float64 elements alive at once in the pdf (the wrapped Gaussian's
# 7 images, a few temporaries each), and the budget of a photon chunk
ENERGY_DRAW_BLOCKS = 32
ENERGY_DRAW_BUDGET_BYTES = 2 << 30


def energy_draw_chunk(ngrid: int) -> int:
    """Photons whose (photons, ngrid) pdf matrix one
    ``LCEnergyTemplate.random`` chunk evaluates: the largest count whose
    working set, ENERGY_DRAW_BLOCKS float64 elements a matrix entry, fits
    ENERGY_DRAW_BUDGET_BYTES (2 GiB). Each photon's draw reads only its
    own row, so the draws do not depend on the chunk."""
    return max(1, ENERGY_DRAW_BUDGET_BYTES
               // (ENERGY_DRAW_BLOCKS * 8 * max(1, int(ngrid))))
