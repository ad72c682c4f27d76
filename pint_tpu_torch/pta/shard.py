"""Batch padding of the pulsar axis (a port of ``pad_batch`` of
pint_tpu/pta/shard.py). Compiling a batch kernel over a device mesh
(``compile_with_plan``, ``batch_sharding``) is ROADMAP.md item 11; on
one device there is nothing to pad to."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["pad_batch"]


def pad_batch(arrs: Dict[str, np.ndarray], mesh, axis: str = "pulsar",
              ones_keys: Sequence[str] = ("nvec", "phi")) -> dict:
    """Pad every array's leading (pulsar) dim up to a multiple of the
    mesh's ``axis`` size. Pad slots are fully masked pulsars: unit
    ``nvec``/``phi`` (so logs and reciprocals stay finite), zeros
    elsewhere (valid = pvalid = 0 masks them out of every sum) — the
    convention ``stack_problems`` uses for extra batch slots. With
    ``mesh=None`` it returns a copy of the dict."""
    if mesh is None:
        return dict(arrs)
    nshard = mesh.shape[axis]
    P = next(iter(arrs.values())).shape[0]
    pad = (-P) % nshard
    if not pad:
        return dict(arrs)
    out = {}
    for k, v in arrs.items():
        v = np.asarray(v)
        fill = np.ones if k in ones_keys else np.zeros
        out[k] = np.concatenate(
            [v, fill((pad,) + v.shape[1:], dtype=v.dtype)], axis=0)
    return out
