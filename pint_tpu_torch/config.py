"""Runtime settings (a copy of the functions of pint_tpu/config.py that
the port calls).

- $PINT_TPU_CLOCK_DIR     : directory of TEMPO/TEMPO2 clock files
- $PINT_TPU_EPHEM_DIR     : directory of SPK .bsp ephemeris kernels
- $PINT_TPU_OBS_OVERRIDE  : JSON file overriding the observatory table
- $PINT_TPU_STREAM_MIN_TOA: TOA count from which Fitter.auto streams
- $PINT_TPU_STREAM_CHUNK  : chunk length of the streaming accumulator
- $PINT_TPU_CHAIN_CHUNK   : MCMC steps a chain chunk runs
- $PINT_TPU_GWB_CHUNK     : GWB grid points a sweep chunk evaluates
- $PINT_TPU_DISPATCH_*, $PINT_TPU_BREAKER_*: the dispatch supervisor
  (``runtime``): deadline, retries, backoff, compile allowance, the
  RTT override; breaker threshold, cooldown and probe timeout
- $PINT_TPU_HOST_SOLVE_MAX_TOA: TOA count below which a fit's solves
  run on the CPU (default 0: never)
- $PINT_TPU_TRACE, $PINT_TPU_TRACE_STREAM, $PINT_TPU_TRACE_RING,
  $PINT_TPU_FLIGHT_DIR, $PINT_TPU_LOCK_TRACE: the obs core
- $PINT_TPU_SLO, $PINT_TPU_SLO_INTERVAL_S: the SLO burn-rate watchdog
- $PINT_TPU_HEALTH, $PINT_TPU_SHADOW_RATE, $PINT_TPU_HEALTH_*: the
  numerical-health plane (``obs.health``)
- $PINT_TPU_PERF, $PINT_TPU_COMPILE_LEDGER, $PINT_TPU_PROFILE_DIR,
  $PINT_TPU_PROFILE_MAX_S: the performance-attribution plane
  (``obs.perf``)
- $PINT_TPU_SERVE_*, $PINT_TPU_TENANT_*, $PINT_TPU_SHED_POLICY,
  $PINT_TPU_AOT_DIR, $PINT_TPU_JOURNAL*, $PINT_TPU_DONATE,
  $PINT_TPU_METRICS_PORT, $PINT_TPU_POOLS, $PINT_TPU_FLEET_*: the serve
  layer (``serve``) and its fleet
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["chain_chunk_steps", "clock_dir", "energy_draw_chunk",
           "ephem_dir", "grid_chunk", "gwb_chunk", "obs_override",
           "photon_walker_chunk", "solve_streaming", "stream_chunk",
           "dispatch_rtt_override_ms", "dispatch_rtt_ms",
           "auto_steps_per_dispatch", "remeasure_dispatch_rtt",
           "dispatch_deadline_ms", "dispatch_retries",
           "dispatch_backoff_ms", "dispatch_compile_allowance_ms",
           "breaker_threshold", "breaker_cooldown_s",
           "breaker_probe_timeout_s", "solve_device", "solve_scope",
           "trace_enabled", "trace_stream_path", "trace_ring_size",
           "flight_dir", "lock_trace_enabled", "slo_enabled",
           "slo_interval_s", "slo_specs", "health_enabled",
           "shadow_rate", "health_drift_sigma", "health_chi2_factor",
           "health_resid_sigma", "health_cg_budget_frac",
           "perf_enabled", "compile_ledger_path", "profile_dir",
           "profile_max_s", "donation_enabled", "serve_bucket_edges",
           "serve_window_s", "serve_max_batch", "serve_queue_cap",
           "tenant_qps", "tenant_burst", "shed_policy", "aot_dir",
           "journal_path", "serve_drain_timeout_s",
           "journal_compact_bytes", "metrics_port",
           "serve_pipeline_depth", "pool_spec", "fleet_lease_ttl_s",
           "fleet_heartbeat_s", "fleet_workers", "cuda_home"]

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


def cuda_home() -> Optional[Path]:
    """$CUDA_HOME, the CUDA toolkit the kernels are built with when
    ``nvcc`` is not on PATH; unset gives None, and a value that is not a
    directory warns once and is ignored (None)."""
    raw = os.environ.get("CUDA_HOME")
    if not raw:
        return None
    if not os.path.isdir(raw):
        _warn_once("CUDA_HOME", "is not a directory", raw, None)
        return None
    return Path(raw)


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


# ------------------------------------------------- dispatch supervision
# (copies of pint_tpu/config.py's parsers, same names and validation;
# the RTT is measured per device, the reference's per backend)

_RTT_MS: dict = {}


def _env_number(name: str, default, cast=float):
    """A numeric env override, warning once per distinct bad value
    instead of silently ignoring a typo."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        if (name, raw) not in _WARNED_ENV:
            _WARNED_ENV.add((name, raw))
            log.warning("unparsable $%s=%r; using %r", name, raw,
                        default)
        return default


def _env_bool(name: str, flag=None, default: bool = False,
              context: str = "") -> bool:
    """Tri-state on/off env parser: an explicit ``flag`` wins;
    truthy/falsy values map; anything else warns once and yields
    ``default``."""
    if flag is not None:
        return bool(flag)
    raw = os.environ.get(name, "")
    v = raw.lower()
    if v in ("1", "on", "true", "yes"):
        return True
    if v in ("", "0", "off", "false", "no"):
        return False
    if (name, raw) not in _WARNED_ENV:
        _WARNED_ENV.add((name, raw))
        log.warning("unparsable $%s=%r (want on/off)%s", name, raw,
                    f"; {context}" if context else "")
    return default


def dispatch_rtt_override_ms():
    """The validated $PINT_TPU_DISPATCH_RTT_MS override, or None: the
    one parser ``dispatch_rtt_ms`` and the supervisor's deadline/drift
    logic share. The value must be a finite positive float; anything
    else warns (once per distinct bad value) and is ignored."""
    import math

    val = _env_number("PINT_TPU_DISPATCH_RTT_MS", None)
    if val is None:
        return None
    val = float(val)
    if not math.isfinite(val) or val <= 0.0:
        raw = os.environ.get("PINT_TPU_DISPATCH_RTT_MS")
        key = ("PINT_TPU_DISPATCH_RTT_MS", f"range:{raw}")
        if key not in _WARNED_ENV:
            _WARNED_ENV.add(key)
            log.warning("$PINT_TPU_DISPATCH_RTT_MS=%r is not a "
                        "finite positive RTT; ignoring the override",
                        raw)
        return None
    return val


def dispatch_rtt_ms(device: str = "cpu") -> float:
    """Round trip of ONE trivial call on ``device`` (ms): the minimum
    of three one-element float64 adds read back with ``.item()``, after
    one warm-up, cached per device per process. $PINT_TPU_DISPATCH_RTT_MS
    (validated, read before the cache) skips the measurement."""
    import time

    import torch

    env = dispatch_rtt_override_ms()
    if env is not None:
        return env
    device = str(device)
    if device in _RTT_MS:
        return _RTT_MS[device]
    x = torch.zeros((), dtype=torch.float64, device=device)
    (x + 1.0).item()  # first launch
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        (x + 1.0).item()  # launch + read: the round trip
        ts.append(time.perf_counter() - t0)
    _RTT_MS[device] = min(ts) * 1e3
    return _RTT_MS[device]


def auto_steps_per_dispatch(device: str = "cpu") -> int:
    """Downhill iterations to chain per call, sized from the measured
    round trip: 1 on the CPU; on a CUDA device the smallest power of
    two >= rtt/8 ms, clamped to [4, 32] (a quantized K keeps the set of
    chained programs small). Only the supervisor's drift re-pick reads
    it: ``DeviceDownhillGLSFitter`` keeps K = 1 unless asked (each call
    is the same eager host loop, so K changes neither result nor
    cost)."""
    if str(device) == "cpu":
        return 1
    raw = dispatch_rtt_ms(device) / 8.0
    for k in (4, 8, 16):
        if raw <= k:
            return k
    return 32


def remeasure_dispatch_rtt(device: str = "cpu") -> float:
    """Drop the cached round trips and measure ``device``'s again — the
    supervisor's drift response (it runs this under its watchdog). The
    env override still wins."""
    _RTT_MS.clear()
    return dispatch_rtt_ms(device)


def dispatch_deadline_ms() -> Optional[float]:
    """Hard watchdog-deadline override for every supervised dispatch
    [ms] ($PINT_TPU_DISPATCH_DEADLINE_MS). Default None: the supervisor
    takes 8 x RTT x steps with a floor (1 s on the CPU, 300 s on CUDA)
    plus a first-call compile allowance. The override is PER DISPATCH:
    a pipelined dispatch issued at in-flight depth d waits d x this
    value."""
    v = _env_number("PINT_TPU_DISPATCH_DEADLINE_MS", None)
    return None if v is None else float(v)


def dispatch_retries() -> int:
    """Retries for TRANSIENT dispatch errors before failing over
    ($PINT_TPU_DISPATCH_RETRIES, default 2). Timeouts and sticky CUDA
    errors never retry."""
    return max(0, int(_env_number("PINT_TPU_DISPATCH_RETRIES", 2,
                                  cast=int)))


def dispatch_backoff_ms() -> float:
    """Base retry backoff [ms], doubled per attempt with +0-50%
    jitter ($PINT_TPU_DISPATCH_BACKOFF_MS, default 50)."""
    return max(0.0, float(_env_number("PINT_TPU_DISPATCH_BACKOFF_MS",
                                      50.0)))


def dispatch_compile_allowance_ms() -> float:
    """Extra deadline budget for the FIRST dispatch per call-site key
    ($PINT_TPU_DISPATCH_COMPILE_ALLOWANCE_MS, default 10 min): it covers
    the ``nvcc`` build of a kernel and ``torch.func`` start-up, so a
    cold call does not read as a hang."""
    return max(0.0, float(_env_number(
        "PINT_TPU_DISPATCH_COMPILE_ALLOWANCE_MS", 600_000.0)))


def breaker_threshold() -> int:
    """Consecutive dispatch failures that trip a device's circuit
    breaker OPEN ($PINT_TPU_BREAKER_THRESHOLD, default 3)."""
    return max(1, int(_env_number("PINT_TPU_BREAKER_THRESHOLD", 3,
                                  cast=int)))


def breaker_cooldown_s() -> float:
    """Seconds an OPEN breaker short-circuits dispatches before the
    next bounded half-open re-probe ($PINT_TPU_BREAKER_COOLDOWN_S,
    default 60); doubles per failed re-probe, capped at 8 minutes."""
    return max(0.0, float(_env_number("PINT_TPU_BREAKER_COOLDOWN_S",
                                      60.0)))


def breaker_probe_timeout_s() -> float:
    """Kill timer on the half-open subprocess device probe
    ($PINT_TPU_BREAKER_PROBE_TIMEOUT_S, default 150, at least 1)."""
    return max(1.0, float(_env_number(
        "PINT_TPU_BREAKER_PROBE_TIMEOUT_S", 150.0)))


def solve_device(ntoa: int, device="cpu"):
    """The CPU device when a fit of ``ntoa`` TOAs on the CUDA ``device``
    should run its solves on the CPU, else None. Opt-in:
    $PINT_TPU_HOST_SOLVE_MAX_TOA (default 0 = never) pins every fit
    below that many TOAs. The reference pins below 1,024 TOAs by default
    on an accelerator, where a dispatch costs 0.1-250 ms; here entry
    points run on the card unless the caller asks otherwise, and the
    crossover on the card is measured (PERF.md) before any default."""
    import torch

    if torch.device(device).type == "cpu":
        return None
    thresh = _env_int("PINT_TPU_HOST_SOLVE_MAX_TOA", 0)
    if thresh <= 0 or ntoa >= thresh:
        return None
    return torch.device("cpu")


def solve_scope(ntoa: int, device="cpu"):
    """Context manager form of ``solve_device``: ``torch.device("cpu")``
    as the default device when the solve is pinned, else a no-op."""
    import contextlib

    dev = solve_device(ntoa, device)
    return dev if dev is not None else contextlib.nullcontext()


# ---------------------------------------------------- observability


def trace_enabled() -> bool:
    """Structured span tracing ($PINT_TPU_TRACE, default OFF): every
    supervised dispatch and device fit emits causally-linked spans
    into the process tracer's ring (``pint_tpu_torch.obs``). Off, the
    hot path pays a single branch per instrumentation point."""
    return os.environ.get("PINT_TPU_TRACE", "").lower() in (
        "1", "on", "true", "yes")


def trace_stream_path():
    """JSONL span-stream path ($PINT_TPU_TRACE_STREAM; None =
    disabled): completed spans/events are appended one JSON object per
    line as they complete. Implies tracing."""
    p = os.environ.get("PINT_TPU_TRACE_STREAM")
    return p if p else None


def trace_ring_size() -> int:
    """Span-ring capacity ($PINT_TPU_TRACE_RING, default 16384, at
    least 256)."""
    return max(256, int(_env_number("PINT_TPU_TRACE_RING", 16384,
                                    cast=int)))


def flight_dir():
    """Flight-recorder dump directory ($PINT_TPU_FLIGHT_DIR; None =
    disabled): on a breaker opening (or a device lost) the tracer's
    recent-span ring is dumped to a timestamped JSON file there.
    Arming it turns on span recording even when $PINT_TPU_TRACE is
    off."""
    d = os.environ.get("PINT_TPU_FLIGHT_DIR")
    return d if d else None


def lock_trace_enabled(flag: Optional[bool] = None) -> bool:
    """Traced-lock sanitizer armed? ($PINT_TPU_LOCK_TRACE, default
    OFF.) Armed, ``runtime.locks`` hands out TracedLock/TracedRLock
    wrappers that record per-thread acquisition order into the process
    lock-order graph; disarmed, the bare stdlib primitives. An explicit
    ``flag`` wins; an unrecognized env value warns once and is
    ignored."""
    return _env_bool("PINT_TPU_LOCK_TRACE", flag,
                     context="lock tracing stays off")


def slo_enabled() -> bool:
    """SLO burn-rate watchdog armed? ($PINT_TPU_SLO, default OFF.) Any
    value ``slo_specs`` resolves to a non-empty spec list arms it: a
    truthy flag (the default spec set), inline JSON, or a JSON file
    path. Off costs nothing: no sampling thread, no ring."""
    raw = os.environ.get("PINT_TPU_SLO", "")
    if raw.lower() in ("", "0", "off", "false", "no"):
        return False
    return bool(slo_specs())


def slo_interval_s() -> float:
    """SLO self-sampling interval [s] ($PINT_TPU_SLO_INTERVAL_S, default
    10): how often the watchdog snapshots the registry into its ring.
    Validated finite positive; warn-and-ignore otherwise."""
    return _env_positive_float("PINT_TPU_SLO_INTERVAL_S", 10.0)


def slo_specs() -> list:
    """Validated SLO spec list from $PINT_TPU_SLO:

    - a truthy flag ("1"/"on"/"true"/"yes") -> the default spec set
      (``obs.slo.default_specs``);
    - a JSON array (inline, or the contents of the file the value
      points at) -> custom specs, each entry validated by
      ``SLOSpec.from_dict``: an invalid entry warns and is dropped, an
      unreadable value warns and yields [] (the watchdog stays off).
    """
    import json

    from pint_tpu_torch.obs.slo import SLOSpec, default_specs

    raw = os.environ.get("PINT_TPU_SLO", "")
    v = raw.strip()
    if v.lower() in ("", "0", "off", "false", "no"):
        return []
    if v.lower() in ("1", "on", "true", "yes"):
        return default_specs()
    text = v
    if not v.startswith(("[", "{")):
        try:
            with open(v, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            if ("PINT_TPU_SLO", raw) not in _WARNED_ENV:
                _WARNED_ENV.add(("PINT_TPU_SLO", raw))
                log.warning("$PINT_TPU_SLO=%r is neither a flag, JSON, "
                            "nor a readable file; SLO watchdog stays off",
                            raw)
            return []
    try:
        entries = json.loads(text)
        if isinstance(entries, dict):
            entries = [entries]
    except ValueError:
        if ("PINT_TPU_SLO", raw) not in _WARNED_ENV:
            _WARNED_ENV.add(("PINT_TPU_SLO", raw))
            log.warning("unparsable $PINT_TPU_SLO JSON; SLO watchdog "
                        "stays off")
        return []
    out = []
    for e in entries:
        try:
            out.append(SLOSpec.from_dict(e))
        except (ValueError, TypeError) as exc:
            key = ("PINT_TPU_SLO", f"entry:{e!r}"[:200])
            if key not in _WARNED_ENV:
                _WARNED_ENV.add(key)
                log.warning("dropping invalid SLO spec entry: %s", exc)
    return out


# ------------------------------------------------- numerical health


def _warn_env_range(name: str, default):
    """Once-per-distinct-value out-of-range warning (the shared tail of
    the validated numeric parsers below)."""
    raw = os.environ.get(name)
    key = (name, f"range:{raw}")
    if key not in _WARNED_ENV:
        _WARNED_ENV.add(key)
        log.warning("$%s=%r is out of range; using %r", name, raw, default)


def _env_positive_float(name: str, default: float,
                        minimum_exclusive: float = 0.0) -> float:
    """Validated finite float env knob > ``minimum_exclusive``;
    warn-and-ignore on anything else."""
    import math

    v = float(_env_number(name, default))
    if not math.isfinite(v) or v <= minimum_exclusive:
        _warn_env_range(name, default)
        return default
    return v


def _env_nonneg_int(name: str, default: int) -> int:
    """Validated non-negative int env knob; warn-and-ignore otherwise."""
    v = int(_env_number(name, default, cast=int))
    if v < 0:
        _warn_env_range(name, default)
        return default
    return v


def f32_mode(env_name: str,
             flag: Optional[bool] = None) -> Optional[bool]:
    """The one tri-state parser of the precision-route env vars
    ($PINT_TPU_ANCHORED, $PINT_TPU_JAC, $PINT_TPU_GLS_MATMUL): an
    explicit ``flag`` wins; else True for f32-ish values, False for
    f64-ish ones, None (auto) when unset. An unrecognized value warns
    once and counts as unset. Auto means float64 on the GPU and on the
    CPU (``parallel.fit_step._resolve_f32``)."""
    if flag is not None:
        return bool(flag)
    raw = os.environ.get(env_name, "")
    v = raw.lower()
    if v in ("f32", "float32", "on", "true", "1"):
        return True
    if v in ("f64", "float64", "off", "false", "0"):
        return False
    if v and (env_name, raw) not in _WARNED_ENV:
        _WARNED_ENV.add((env_name, raw))
        log.warning("unparsable $%s=%r (want f32/f64/on/off); "
                    "using the float64 default", env_name, raw)
    return None


def health_enabled(flag: Optional[bool] = None) -> bool:
    """In-trace numerical-health taps armed? ($PINT_TPU_HEALTH, default
    OFF.) Armed, the fit step, the fit loop, the GLS solve and the
    streaming chunk return a cheap health vector as extra outputs of
    the same call (non-finite counts, max residual in sigma, CG effort),
    and ``obs.health.HealthMonitor`` evaluates it against the thresholds
    below. Disarmed, the taps are not built: the step runs exactly the
    ops it runs without health. An explicit ``flag`` wins; an
    unrecognized env value warns once and is ignored (stays off)."""
    return _env_bool("PINT_TPU_HEALTH", flag,
                     context="health taps stay off")


def shadow_rate() -> int:
    """Shadow-oracle drift sampling rate ($PINT_TPU_SHADOW_RATE; default
    0 = off): every Nth successful supervised dispatch of a
    shadow-capable key replays the completed solve on the numpy mirror
    in a background thread and records device-vs-host drift in sigma.
    Validated non-negative int; warn-and-ignore otherwise."""
    return _env_nonneg_int("PINT_TPU_SHADOW_RATE", 0)


def health_drift_sigma() -> float:
    """Shadow-oracle drift band [sigma] ($PINT_TPU_HEALTH_DRIFT_SIGMA;
    route-aware auto default): device-vs-mirror parameter drift beyond
    this many sigma is a ``numerics:drift`` incident. The auto band
    follows the active precision routes, as the reference's does:

    - float64 routes (the default): 1e-5. The measured float64 replay
      floor sits decades below it, while an unsanctioned float32
      demotion lands above it;
    - a sanctioned float32 route set through the environment
      ($PINT_TPU_GLS_MATMUL or $PINT_TPU_JAC reading f32): 2e-2, above
      the routes' documented agreement bound, so a healthy worker on
      its own sanctioned quantization does not flap.

    The reference also widens the band when its backend is a TPU (where
    auto picks float32); the port never picks float32 by itself, so it
    keeps no such branch. An explicit env value wins (validated finite
    positive, warn-and-ignore otherwise)."""
    auto = 1e-5
    for env in ("PINT_TPU_GLS_MATMUL", "PINT_TPU_JAC"):
        if f32_mode(env) is True:
            auto = 2e-2
            break
    return _env_positive_float("PINT_TPU_HEALTH_DRIFT_SIGMA", auto)


def health_chi2_factor() -> float:
    """chi2 blow-up incident threshold ($PINT_TPU_HEALTH_CHI2_FACTOR,
    default 4.0): a step whose chi2 grows past factor x the previous
    accepted value is a ``numerics:chi2_blowup`` incident. Validated
    finite > 1."""
    return _env_positive_float("PINT_TPU_HEALTH_CHI2_FACTOR", 4.0,
                               minimum_exclusive=1.0)


def health_resid_sigma() -> float:
    """Max |residual|/sigma incident threshold
    ($PINT_TPU_HEALTH_RESID_SIGMA, default 1e8): a whitened residual
    past this is numeric garbage, not a bad timing model. Validated
    finite positive."""
    return _env_positive_float("PINT_TPU_HEALTH_RESID_SIGMA", 1e8)


def health_cg_budget_frac() -> float:
    """CG effort incident threshold as a fraction of the iteration
    budget ($PINT_TPU_HEALTH_CG_BUDGET_FRAC, default 1.0 = exhaustion
    only): iterations >= frac x budget is a ``numerics:cg_budget``
    incident. Validated finite in (0, 1]; a larger value warns and gives
    1.0."""
    v = _env_positive_float("PINT_TPU_HEALTH_CG_BUDGET_FRAC", 1.0)
    if v > 1.0:
        _warn_env_range("PINT_TPU_HEALTH_CG_BUDGET_FRAC", 1.0)
        return 1.0
    return v


# ------------------------------------------- performance attribution


def perf_enabled(flag: Optional[bool] = None) -> bool:
    """Dispatch-wall decomposition armed? ($PINT_TPU_PERF, default OFF.)
    Armed, every successful guarded supervised dispatch splits its wall
    into queue_wait / host_assembly / device_wall / collect
    (``obs.perf`` + ``RuntimeMetrics.perf``); disarmed, the supervisor
    pays one attribute read and a branch. The compile ledger is always
    on. An explicit ``flag`` wins; an unrecognized env value warns once
    and is ignored."""
    return _env_bool("PINT_TPU_PERF", flag,
                     context="perf decomposition stays off")


def compile_ledger_path():
    """JSONL persistence path of the compile ledger
    ($PINT_TPU_COMPILE_LEDGER; None = registry only). Armed, every new
    or changed ledger entry appends one JSON line, and a restarted
    process reads the file back as ``prior`` entries."""
    p = os.environ.get("PINT_TPU_COMPILE_LEDGER")
    return p if p else None


def profile_dir():
    """Profiler-window directory ($PINT_TPU_PROFILE_DIR; None = windows
    disarmed). Armed, ``obs.perf.request_window`` and the one-shot
    incident windows (slo_burn, breaker-open) each write one
    ``window-<utc>-<reason>/`` directory: the torch.profiler device
    trace, ``window.json`` metadata and a ``spans.json`` span export."""
    d = os.environ.get("PINT_TPU_PROFILE_DIR")
    return d if d else None


def profile_max_s() -> float:
    """Hard bound on one profiler window [s] ($PINT_TPU_PROFILE_MAX_S,
    default 30): every requested window is clamped to it. Validated
    finite positive; warn-and-ignore otherwise."""
    return _env_positive_float("PINT_TPU_PROFILE_MAX_S", 30.0)


# ------------------------------------------------------------ serving
# (copies of pint_tpu/config.py's serve and fleet parsers, same
# variables, defaults and validation)


def donation_enabled(flag: Optional[bool] = None) -> bool:
    """Buffer donation at the dispatch boundary ($PINT_TPU_DONATE,
    default ON in the reference). Eager torch has no donation: the serve
    engine parses the knob and records ``donation: false`` in its
    snapshot, whatever it says."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("PINT_TPU_DONATE", "").lower() \
        not in ("off", "false", "0")


def serve_bucket_edges() -> tuple:
    """TOA-count bucket edges of the serve layer's shape classes
    (``serve.bucket``): requests pad up to the smallest edge that fits.
    Default: powers of two 64..16384 (16384 covers the NANOGrav-scale
    stress shape). $PINT_TPU_SERVE_BUCKETS, a comma-separated int list,
    overrides."""
    raw = os.environ.get("PINT_TPU_SERVE_BUCKETS")
    if raw:
        try:
            edges = tuple(sorted(int(x) for x in raw.split(",")
                                 if x.strip()))
            if edges and all(e > 0 for e in edges):
                return edges
        except ValueError:
            pass
        if ("PINT_TPU_SERVE_BUCKETS", raw) not in _WARNED_ENV:
            _WARNED_ENV.add(("PINT_TPU_SERVE_BUCKETS", raw))
            log.warning("unparsable $PINT_TPU_SERVE_BUCKETS=%r; "
                        "using defaults", raw)
    return tuple(64 * 2 ** k for k in range(9))  # 64..16384


def serve_window_s() -> float:
    """Coalescing window of the threaded serving loop [s]
    ($PINT_TPU_SERVE_WINDOW_MS, milliseconds; default 5 ms)."""
    return float(_env_number("PINT_TPU_SERVE_WINDOW_MS", 5.0)) / 1e3


def serve_max_batch() -> int:
    """Max requests coalesced into one dispatch
    ($PINT_TPU_SERVE_MAX_BATCH, default 64)."""
    return max(1, int(_env_number("PINT_TPU_SERVE_MAX_BATCH", 64,
                                  cast=int)))


def serve_queue_cap() -> int:
    """Admission-queue capacity ($PINT_TPU_SERVE_QUEUE_CAP, default
    4096); a full queue rejects with ServeOverload."""
    return max(1, int(_env_number("PINT_TPU_SERVE_QUEUE_CAP", 4096,
                                  cast=int)))


def tenant_qps() -> float:
    """Per-tenant admission rate [requests/s] ($PINT_TPU_TENANT_QPS;
    0, the default, disables the quotas)."""
    return max(0.0, float(_env_number("PINT_TPU_TENANT_QPS", 0.0)))


def tenant_burst() -> float:
    """Token-bucket capacity per tenant ($PINT_TPU_TENANT_BURST;
    default 2x the rate, at least 1)."""
    qps = tenant_qps()
    return max(1.0, float(_env_number("PINT_TPU_TENANT_BURST",
                                      max(1.0, 2.0 * qps))))


def shed_policy() -> str:
    """Load shedding at capacity ($PINT_TPU_SHED_POLICY): "deadline"
    (default; shed a request that will miss its deadline anyway, never
    one that can still make it) or "reject" (plain backpressure)."""
    v = os.environ.get("PINT_TPU_SHED_POLICY", "deadline").lower()
    if v not in ("deadline", "reject"):
        if ("PINT_TPU_SHED_POLICY", v) not in _WARNED_ENV:
            _WARNED_ENV.add(("PINT_TPU_SHED_POLICY", v))
            log.warning("unknown $PINT_TPU_SHED_POLICY=%r; using "
                        "'deadline'", v)
        return "deadline"
    return v


def aot_dir():
    """Warm-restart store of the serve shape classes ($PINT_TPU_AOT_DIR;
    None = off): the manifest of every class an engine served on its
    device, which a fresh engine primes at construction."""
    d = os.environ.get("PINT_TPU_AOT_DIR")
    return d if d else None


def journal_path():
    """Append-only serve request journal ($PINT_TPU_JOURNAL; None =
    off)."""
    p = os.environ.get("PINT_TPU_JOURNAL")
    return p if p else None


def serve_drain_timeout_s() -> float:
    """Bound on the graceful-shutdown drain
    ($PINT_TPU_SERVE_DRAIN_TIMEOUT_S, default 30 s)."""
    return max(0.0, float(_env_number(
        "PINT_TPU_SERVE_DRAIN_TIMEOUT_S", 30.0)))


def journal_compact_bytes() -> int:
    """Journal size past which ``RequestJournal`` auto-compacts
    ($PINT_TPU_JOURNAL_COMPACT_BYTES, default 16 MiB, 0 disables)."""
    return max(0, int(_env_number("PINT_TPU_JOURNAL_COMPACT_BYTES",
                                  16 * 1024 * 1024, cast=int)))


def metrics_port() -> Optional[int]:
    """Default /metrics port of the daemon ($PINT_TPU_METRICS_PORT;
    None = off, 0 = ephemeral). Validated int in [0, 65535]."""
    v = _env_number("PINT_TPU_METRICS_PORT", None, cast=int)
    if v is None:
        return None
    v = int(v)
    if not 0 <= v <= 65535:
        raw = os.environ.get("PINT_TPU_METRICS_PORT")
        key = ("PINT_TPU_METRICS_PORT", f"range:{raw}")
        if key not in _WARNED_ENV:
            _WARNED_ENV.add(key)
            log.warning("$PINT_TPU_METRICS_PORT=%r out of range; "
                        "metrics server stays off", raw)
        return None
    return v


def serve_pipeline_depth() -> int:
    """Sealed units the serve drain keeps in flight
    ($PINT_TPU_SERVE_PIPELINE, default 2; 1 = the synchronous drain)."""
    return max(1, int(_env_number("PINT_TPU_SERVE_PIPELINE", 2,
                                  cast=int)))


def pool_spec() -> Optional[Tuple[str, ...]]:
    """Named capacity pools of the serve router ($PINT_TPU_POOLS,
    comma-separated; None = the classic {"device", "host"} pair). The
    spec must hold "device" and "host" and lowercase identifier-ish
    names; a malformed spec warns once and is ignored."""
    raw = os.environ.get("PINT_TPU_POOLS", "")
    if not raw:
        return None
    names = tuple(s.strip() for s in raw.split(",") if s.strip())
    ok = (len(names) == len(set(names)) and "device" in names
          and "host" in names
          and all(n.replace("_", "").replace("-", "").isalnum()
                  and n == n.lower() for n in names))
    if not ok:
        if ("PINT_TPU_POOLS", raw) not in _WARNED_ENV:
            _WARNED_ENV.add(("PINT_TPU_POOLS", raw))
            log.warning(
                "malformed $PINT_TPU_POOLS=%r (want unique lowercase "
                "comma-separated names including 'device' and "
                "'host'); using the classic pools", raw)
        return None
    return names


def fleet_lease_ttl_s() -> float:
    """Worker lease time-to-live [s] ($PINT_TPU_FLEET_LEASE_TTL_S,
    default 15). Validated finite positive."""
    return _env_positive_float("PINT_TPU_FLEET_LEASE_TTL_S", 15.0)


def fleet_heartbeat_s() -> float:
    """Worker heartbeat period [s] ($PINT_TPU_FLEET_HEARTBEAT_S, default
    5); values at or above the lease TTL are clamped to TTL/3."""
    v = _env_positive_float("PINT_TPU_FLEET_HEARTBEAT_S", 5.0)
    ttl = fleet_lease_ttl_s()
    if v >= ttl:
        _warn_env_range("PINT_TPU_FLEET_HEARTBEAT_S", ttl / 3.0)
        return ttl / 3.0
    return v


def fleet_workers() -> int:
    """Default fleet size ($PINT_TPU_FLEET_WORKERS, default 3, min 1)."""
    v = int(_env_number("PINT_TPU_FLEET_WORKERS", 3, cast=int))
    if v < 1:
        _warn_env_range("PINT_TPU_FLEET_WORKERS", 3)
        return 3
    return v
