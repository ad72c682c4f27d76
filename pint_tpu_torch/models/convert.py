"""Carry a reference evaluation's inputs across to the port.

There are no learned weights in a timing model: what crosses over is the
packed parameter vector (``pint_tpu`` ``TimingModel._pack()``: names and
double-double (hi, lo) values of the free and frozen parameters) and the
TOA batch (the ``ToaBatch`` leaves). Both arrive as numpy arrays, so the
same inputs can be fed to both phase chains without either parser.
``fit_args_from_numpy`` carries a whole fit-step argument tuple across
(parameters, batch, per-TOA cache with its mask leaves — JUMP, DMJUMP,
FDJUMP, DMX — and a wideband step's ``wb_dm``/``wb_dme``/``wb_Fdm``
leaves, noise bases, ECORR segments), and ``toas_from_columns`` a
processed TOA table (its host columns, the -pp_dm/-pp_dme flags
among them). ``prior_from_reference`` gives a parameter the port's
counterpart of a reference prior.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.ops.dd import DD


def params_from_packed(free_names: Sequence[str],
                       frozen_names: Sequence[str], th, tl, fh, fl,
                       device=None) -> Dict[str, DD]:
    """{name: DD of 0-d float64 tensors} on ``device`` from a packed
    parameter vector (the output of ``TimingModel._pack()``)."""
    dev = resolve_device(device)
    pv: Dict[str, DD] = {}
    for names, hi, lo in ((free_names, th, tl), (frozen_names, fh, fl)):
        hi = torch.as_tensor(np.asarray(hi, np.float64), device=dev)
        lo = torch.as_tensor(np.asarray(lo, np.float64), device=dev)
        for i, nm in enumerate(names):
            pv[nm] = DD(hi[i], lo[i])
    return pv


def batch_from_numpy(leaves: dict, device=None):
    """A port ``ToaBatch`` on ``device`` from the reference batch's
    leaves as numpy arrays (``tdb_frac`` as its (hi, lo) pair)."""
    from pint_tpu_torch.toa import ToaBatch, pack_batch

    cols = {k: np.asarray(leaves[k], np.float64)
            for k in ToaBatch._fields if k != "tdb_frac"}
    hi, lo = leaves["tdb_frac"]
    cols["tdb_frac_hi"] = np.asarray(hi, np.float64)
    cols["tdb_frac_lo"] = np.asarray(lo, np.float64)
    return pack_batch(cols, resolve_device(device))


def _batch_leaves(batch) -> dict:
    """{leaf: numpy} of a batch-like NamedTuple (``tdb_frac`` as its
    (hi, lo) pair)."""
    out = {k: np.asarray(v) for k, v in batch._asdict().items()
           if k != "tdb_frac"}
    out["tdb_frac"] = tuple(np.asarray(x) for x in batch.tdb_frac)
    return out


def _cache_from_numpy(cache: dict, dev) -> dict:
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _cache_from_numpy(v, dev)
        elif hasattr(v, "_asdict"):
            out[k] = batch_from_numpy(_batch_leaves(v), dev)
        else:
            out[k] = torch.as_tensor(np.array(v, np.float64), device=dev)
    return out


def fit_args_from_numpy(args: Sequence, device=None) -> tuple:
    """A fit step's 12 arguments (th, tl, fh, fl, batch, cache, F, phi,
    nvec, valid, eid, jvar) as the port's step_fn takes them, from any
    array-likes that numpy can read: float64 tensors on ``device``,
    the batch and the cache's TZR batch as port ``ToaBatch``es, the
    epoch ids as int64."""
    dev = resolve_device(device)
    th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid, jvar = args

    def f64(x):
        return torch.as_tensor(np.array(x, np.float64), device=dev)

    return (f64(th), f64(tl), f64(fh), f64(fl),
            batch_from_numpy(_batch_leaves(batch), dev),
            _cache_from_numpy(cache, dev), f64(F), f64(phi), f64(nvec),
            f64(valid), torch.as_tensor(np.array(eid, np.int64),
                                        device=dev), f64(jvar))


def prior_from_reference(obj):
    """The port's prior of the same class as the reference prior ``obj``
    (None stays None), read by class name and attributes (``lower`` and
    ``upper``, ``mu`` and ``sigma``, ``base``) without importing the
    reference."""
    from pint_tpu_torch.models import priors

    if obj is None:
        return None
    name = type(obj).__name__
    if name not in priors.__all__:
        raise TypeError(f"no port prior for {name}")
    cls = getattr(priors, name)
    if name == "UniformPrior":
        return cls(obj.lower, obj.upper)
    if name == "GaussianPrior":
        return cls(obj.mu, obj.sigma)
    if name == "Log10TransformedPrior":
        return cls(prior_from_reference(obj.base))
    return cls()


_TOA_COLUMNS = ("mjd_day", "mjd_frac", "freq_mhz", "error_us", "obs",
                "flags", "names", "clock_applied", "tdb_day", "tdb_frac",
                "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos",
                "obs_planet_pos", "ephem", "planets")


def toas_from_columns(src, device=None):
    """A port ``TOAs`` holding copies of the host columns of a processed
    TOA table ``src`` (clock-corrected, TDBs and positions computed), so
    both packages see the same TOAs without running either pipeline
    again."""
    import copy

    from pint_tpu_torch.toa import _TOAS_SERIAL, TOAs

    out = object.__new__(TOAs)
    for k in _TOA_COLUMNS:
        setattr(out, k, copy.deepcopy(getattr(src, k)))
    out.device = resolve_device(device)
    out.weights = None
    out._serial = next(_TOAS_SERIAL)
    return out
