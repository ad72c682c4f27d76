"""Carry a reference evaluation's inputs across to the port.

There are no learned weights in a timing model: what crosses over is the
packed parameter vector (``pint_tpu`` ``TimingModel._pack()``: names and
double-double (hi, lo) values of the free and frozen parameters) and the
TOA batch (the ``ToaBatch`` leaves). Both arrive as numpy arrays, so the
same inputs can be fed to both phase chains without either parser.
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
