"""The affine-invariant ensemble chunk (a port of
pint_tpu/sampling/kernel.py).

Reference: src/pint/sampler.py (EmceeSampler) / Goodman & Weare 2010.
A chunk of K stretch-move steps (both half-ensemble updates, the
accept/reject, thinning) runs as a host loop over device tensors; every
tensor may carry leading batch axes (independent ensembles, e.g. one per
pulsar), which each step updates at once.

Design contracts (those of the reference):

- **budget**: the chunk length K is fixed when it is built; the steps
  actually run ride along as a runtime ``budget`` (per ensemble), and
  steps past it leave the state and the acceptance count untouched.
- **positional random streams**: step i draws its numbers from a hash of
  (seed, offset + i, stream, element) — no carried generator state — so
  a chain cut into chunks of any length draws the identical numbers.
  torch has no ``jax.random.fold_in``; the hash is a counter-based
  generator written in int64 tensor ops (``uniforms``), which gives the
  same bits on the CPU and the GPU. It is not ``jax.random``: the chain
  cannot match the reference's bits, only its statistics.
- **thinning**: the emitted chain keeps every ``thin``-th state.
"""

from __future__ import annotations

import torch

__all__ = ["build_stretch_chunk", "normals", "uniforms"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2**32 for an int64 tensor x in [0, 2**32) and a
    constant c < 2**32, in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x):
    """A 32-bit integer finalizer (Wellons' lowbias32) on int64 tensors
    holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(seed, steps, nstreams: int, n: int, first_stream: int = 0):
    """Uniform draws in (0, 1), float64, of shape seed.shape + (len(steps),
    nstreams, n): element [..., i, s, j] is a hash of (seed[...],
    steps[i], first_stream + s, j) alone. ``seed`` is an int64 tensor
    (any shape, one ensemble each) and ``steps`` an int64 tensor of
    global step indices, both on the device the draws are made on."""
    dev = seed.device
    streams = torch.arange(first_stream, first_stream + nstreams,
                           dtype=torch.int64, device=dev)
    h = _mix((seed & _M32) ^ _GOLDEN)
    h = _mix(h ^ ((seed >> 32) & _M32))[..., None]
    h = _mix(h ^ (steps & _M32))[..., None]
    h = _mix(h ^ streams)[..., None]
    h = _mix(h ^ torch.arange(n, dtype=torch.int64, device=dev))
    return (h.to(torch.float64) + 0.5) * 2.0 ** -32


def normals(seed, step: int, stream: int, n: int):
    """Standard normal draws (Box–Muller over streams ``stream`` and
    ``stream + 1`` of step ``step``), of shape seed.shape + (n,)."""
    steps = torch.full((1,), step, dtype=torch.int64, device=seed.device)
    u = uniforms(seed, steps, 2, n, first_stream=stream)[..., 0, :, :]
    return torch.sqrt(-2.0 * torch.log(u[..., 0, :])) * \
        torch.cos(2.0 * torch.pi * u[..., 1, :])


def build_stretch_chunk(logp_batch, nwalkers: int, ndim, nsteps: int,
                        thin: int = 1, a: float = 2.0):
    """Build the chunk function for ensembles of ``nwalkers`` walkers.

    ``logp_batch``: (..., half, D) -> (..., half) log-posterior
    (non-finite values are never accepted — the -inf prior convention of
    the host sampler). ``ndim`` is an int, or a tensor of the batch shape
    holding each ensemble's REAL dimension count (padded dimensions add
    no volume to the Hastings factor z^(d-1)); the walker-count check
    then falls to the caller. Returns

        chunk(pos, lp, seed, budget, offset)
            -> (pos', lp', naccept, chain, lnprob)

    with ``pos`` (..., W, D) float64, ``lp`` (..., W), ``seed`` an int64
    tensor of the batch shape, ``budget`` an int or an int64 tensor of
    the batch shape (steps to actually run in this chunk), ``offset`` an
    int (the global step index of the chunk's first step), ``chain``
    (..., K//thin, W, D) and ``lnprob`` (..., K//thin, W) — rows past the
    budget repeat the final state and are sliced off by the caller.
    ``naccept`` (int64, the batch shape) counts accepted walker moves.
    """
    if isinstance(ndim, int) and \
            (nwalkers < 2 * ndim or nwalkers % 2):
        raise ValueError(
            "need an even nwalkers >= 2*ndim for ensemble moves")
    if nwalkers % 2:
        raise ValueError("need an even nwalkers")
    if thin < 1 or nsteps % thin:
        raise ValueError("thin must be >= 1 and divide the chunk size")
    half = nwalkers // 2
    a = float(a)
    dim_m1 = ndim - 1.0 if isinstance(ndim, int) \
        else (ndim - 1.0)[..., None]

    def half_move(pos, lp, u, first, live):
        """One stretch-move update of one half of the walkers against
        the other half; ``u`` (..., 3, half) holds the step's draws for
        the stretch factor, the partner and the accept test."""
        lo, olo = (0, half) if first else (half, 0)
        mv = pos[..., lo:lo + half, :]
        ot = pos[..., olo:olo + half, :]
        # z ~ g(z) prop. 1/sqrt(z) on [1/a, a]
        z = ((a - 1.0) * u[..., 0, :] + 1.0) ** 2 / a
        idx = (u[..., 1, :] * half).long()
        partners = torch.gather(ot, -2, idx[..., None].expand(ot.shape))
        prop = partners + z[..., None] * (mv - partners)
        lp_prop = logp_batch(prop)
        lp_mv = lp[..., lo:lo + half]
        logq = dim_m1 * torch.log(z) + lp_prop - lp_mv
        # NaN logq (wild proposal) compares False: never accepted
        accept = (torch.log(u[..., 2, :]) < logq) & live
        new = torch.where(accept[..., None], prop, mv)
        new_lp = torch.where(accept, lp_prop, lp_mv)
        ot_lp = lp[..., olo:olo + half]
        if first:
            pos, lp = torch.cat([new, ot], -2), torch.cat([new_lp, ot_lp], -1)
        else:
            pos, lp = torch.cat([ot, new], -2), torch.cat([ot_lp, new_lp], -1)
        return pos, lp, torch.sum(accept, dim=-1)

    def chunk(pos, lp, seed, budget, offset: int):
        steps = torch.arange(offset, offset + nsteps, dtype=torch.int64,
                             device=pos.device)
        u = uniforms(seed, steps, 6, half)
        if torch.is_tensor(budget):
            budget = budget[..., None]
        acc = torch.zeros(seed.shape, dtype=torch.int64, device=pos.device)
        chain, lnprob = [], []
        for i in range(nsteps):
            live = budget > i
            ui = u[..., i, :, :]
            pos, lp, n1 = half_move(pos, lp, ui[..., 0:3, :], True, live)
            pos, lp, n2 = half_move(pos, lp, ui[..., 3:6, :], False, live)
            acc = acc + n1 + n2
            if (i + 1) % thin == 0:
                chain.append(pos)
                lnprob.append(lp)
        return (pos, lp, acc, torch.stack(chain, dim=-3),
                torch.stack(lnprob, dim=-2))

    return chunk
