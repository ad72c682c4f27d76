"""The device mesh and the block plan of a batch kernel (a port of
pint_tpu/pta/shard.py).

The reference is single-controller: one Python process places blocks on
every device of a ``jax.sharding.Mesh``, and its batch kernels run
through ``shard_map``, each device solving its own contiguous block of
pulsars with zero collectives. The port is the same, eagerly: one
process splits the batch axis (dim 0) into contiguous per-device
blocks, issues the kernel on every block on that block's device (CUDA
launches on different devices are asynchronous, so the blocks overlap)
and only then reads back, concatenating the blocks in block order.

- ``Mesh``: an array of ``torch.device``s (or device strings) with axis
  names, the counterpart of ``jax.sharding.Mesh``. A mesh naming a
  device that does not exist raises at construction; a block never runs
  anywhere but on its device. Several positions may name one device: a
  k-shard mesh on one GPU places every block on it, as the reference's
  tests place 8 virtual devices on one CPU.
- ``batch_sharding``: the block plan, which rows of dim 0 go to which
  device.
- ``compile_with_plan``: the kernel under a plan, cached per (name,
  devices, axis, donation, ranks). Eager torch compiles nothing and
  aliases no buffer: ``donate_argnums`` is kept in the key only.
- ``run_batch``: one call of a batch kernel on host arrays, on one
  device or over a mesh, read back.

This module plans and places; it never dispatches. The supervised call
sites (``parallel.pta.pta_solve``, ``pta.gwb``, ``serve.bucket``) own
the dispatch, under the breaker of the first device of the mesh's axis
(``mesh_devices(mesh, axis)[0]``), where the outputs are gathered.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "Block", "Blocks", "batch_sharding",
           "compile_with_plan", "mesh_devices", "mesh_fingerprint",
           "pad_batch", "plan_cache_clear", "run_batch"]

# plan cache: (name, mesh fingerprint, donate, ranks) -> planned fn.
# Keyed on the mesh's devices, not the Mesh object, so two Mesh
# wrappers over the same devices share one plan.
_PLANS: Dict[tuple, object] = {}


def _checked_device(d) -> torch.device:
    """``d`` as a torch.device that exists on this machine, else
    ValueError. An unindexed CUDA device is cuda:0."""
    dev = torch.device(d)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda":
        idx = 0 if dev.index is None else int(dev.index)
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if idx >= count:
            raise ValueError(
                f"mesh device {dev} does not exist: this machine has "
                f"{count} CUDA device(s)")
        return torch.device("cuda", idx)
    raise ValueError(f"mesh device {dev}: a mesh holds cpu and cuda "
                     "devices only")


class Mesh:
    """A named grid of devices (the port's ``jax.sharding.Mesh``).

    ``devices`` is an array (any nesting numpy accepts) of
    ``torch.device``s or device strings, one axis per name in
    ``axis_names``: ``Mesh(np.array(devs).reshape(k), ("toa",))``.
    ``.shape`` maps each axis name to its size, ``.devices`` is the
    object array of checked ``torch.device``s."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(str(a) for a in axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of {arr.ndim} dimensions needs as "
                             f"many axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_checked_device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))


def _check(mesh):
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a pint_tpu_torch.pta.shard.Mesh, "
                        f"not {type(mesh).__name__}")


def mesh_devices(mesh, axis: str) -> Tuple[torch.device, ...]:
    """The devices along ``axis``, in order (for a mesh of several axes,
    those at the first position of every other axis). Raises TypeError
    for anything but a ``Mesh`` and ValueError for an axis it lacks."""
    _check(mesh)
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes "
                         f"{mesh.axis_names})")
    ax = mesh.axis_names.index(axis)
    moved = np.moveaxis(mesh.devices, ax, 0).reshape(mesh.shape[axis], -1)
    return tuple(moved[:, 0])


def mesh_fingerprint(mesh, axis: str):
    """Hashable identity of (mesh, axis) for the plan cache: (type,
    index) of every mesh position, the axis names and ``axis``."""
    if mesh is None:
        return None
    return (tuple((d.type, d.index) for d in mesh.devices.flat),
            tuple(mesh.axis_names), str(axis))


class Block(NamedTuple):
    """Rows [start, stop) of dim 0, on ``device``."""
    device: torch.device
    start: int
    stop: int


class Blocks(tuple):
    """Per-block values in block order, each on its block's device: an
    output of a planned call (``parallel.pta.read_back`` concatenates
    them) or a TOA-axis argument of a sharded fit step."""


def batch_sharding(mesh, axis: str, n: int) -> Tuple[Block, ...]:
    """The block plan of a leading axis of ``n`` rows over ``axis``:
    contiguous equal blocks, block i on the axis's i-th device. ``n``
    must be a multiple of the axis size (``pad_batch`` pads to one)."""
    devs = mesh_devices(mesh, axis)
    k = len(devs)
    if n % k:
        raise ValueError(f"{n} rows do not split into {k} equal blocks "
                         "(pad the batch with pad_batch first)")
    step = n // k
    return tuple(Block(d, i * step, (i + 1) * step)
                 for i, d in enumerate(devs))


def _place(args, plan):
    """Every block's rows of every host array on the block's device, in
    ONE host-to-device copy per block (``parallel.pta.upload``)."""
    from pint_tpu_torch.parallel.pta import upload

    keys = tuple(range(len(args)))
    out = []
    for blk in plan:
        st = upload({k: a[blk.start:blk.stop] for k, a in zip(keys, args)},
                    keys, blk.device)
        out.append(tuple(st[k] for k in keys))
    return out


def compile_with_plan(fn, *, name: str, ndims_in: Sequence[int],
                      ndims_out: Sequence[int], mesh=None,
                      axis: str = "pulsar",
                      donate_argnums: Tuple[int, ...] = ()):
    """A batch kernel under an explicit placement plan.

    ``fn`` maps leading-axis-batched tensors to a tuple of
    leading-axis-batched outputs (the port's batch kernels are batched
    torch functions where the reference vmaps a per-slot kernel).
    Without a mesh this is ``fn`` itself. With one, the returned
    function takes the batch as host arrays, splits every
    input's dim 0 into the plan's blocks (``batch_sharding``), issues
    ``fn`` on every block on that block's device, all blocks before any
    read back, and returns one ``Blocks`` per output. ``ndims_in`` and
    ``ndims_out`` are the ranks, checked on every call. Plans are cached
    per (name, mesh devices, axis, donation, ranks)."""
    donate = tuple(sorted(int(d) for d in donate_argnums))
    key = (name, mesh_fingerprint(mesh, axis), donate,
           tuple(ndims_in), tuple(ndims_out))
    got = _PLANS.get(key)
    if got is not None:
        return got
    if mesh is None:
        planned = fn
    else:
        nin, nout = tuple(ndims_in), tuple(ndims_out)

        def planned(*args):
            if tuple(np.ndim(a) for a in args) != nin:
                raise ValueError(
                    f"{name}: inputs of ranks "
                    f"{tuple(np.ndim(a) for a in args)}, the plan takes "
                    f"{nin}")
            plan = batch_sharding(mesh, axis, int(args[0].shape[0]))
            outs = [fn(*blk) for blk in _place(args, plan)]
            if any(tuple(o.ndim for o in out) != nout for out in outs):
                raise ValueError(f"{name}: outputs do not have the "
                                 f"plan's ranks {nout}")
            return tuple(Blocks(out[j] for out in outs)
                         for j in range(len(nout)))

        planned.plan = key
    _PLANS[key] = planned
    return planned


def run_batch(fn, arrs: dict, keys: Sequence[str], *, name: str,
              ndims_out: Sequence[int], mesh=None, axis: str = "pulsar",
              device=None) -> tuple:
    """One call of the batch kernel ``fn`` on the host arrays
    ``arrs[k]`` for ``k`` in ``keys``, read back as numpy: on ``device``,
    one upload, ``fn``, one read back; over ``mesh``, the batch padded
    to a multiple of its ``axis`` (``pad_batch``), ``fn``'s block plan
    (``compile_with_plan`` under ``name``) and the first P rows of the
    gathered outputs."""
    from pint_tpu_torch.parallel.pta import read_back, upload

    if mesh is None:
        st = upload(arrs, keys, device)
        return read_back(fn(*(st[k] for k in keys)))
    P = len(arrs[keys[0]])
    padded = pad_batch({k: arrs[k] for k in keys}, mesh, axis)
    host = [np.asarray(padded[k], dtype=np.float64) for k in keys]
    planned = compile_with_plan(fn, name=name,
                                ndims_in=[h.ndim for h in host],
                                ndims_out=ndims_out, mesh=mesh, axis=axis)
    return tuple(o[:P] for o in read_back(planned(*host)))


def plan_cache_clear():
    """Drop every cached plan (tests that rebuild meshes)."""
    _PLANS.clear()


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
