"""DeviceEnsembleSampler: whole chains run in chunks on the device (a
port of pint_tpu/sampling/chain.py).

Reference: src/pint/sampler.py (EmceeSampler) — the same stretch-move
ensemble as ``pint_tpu_torch.sampler.EnsembleSampler``, but the walkers,
their log-posteriors and the random draws stay on the device: each chunk
of K steps (``sampling.kernel.build_stretch_chunk``, K from
``config.chain_chunk_steps``) is one call that reads back only its
acceptance count, and the chain comes back once at the end.

Modes:

- ``mode="scan"`` (default): ceil(nsteps/K) chunks;
- ``mode="host_loop"``: the SAME chunk built at K=1, one call per step.
  The random streams are positional (a hash of the seed and the global
  step), so the two modes draw identical numbers and give the same chain
  bit for bit — host_loop is the oracle of the chunking.

A chunk that fails raises: there is no host failover (the reference's
supervisor re-runs a failed chunk on its CPU device; ROADMAP.md item
11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import config, resolve_device
from pint_tpu_torch.sampler import ChainStats
from pint_tpu_torch.sampling.kernel import build_stretch_chunk

__all__ = ["DeviceEnsembleSampler"]


class DeviceEnsembleSampler(ChainStats):
    """Whole-chain ensemble sampler on ``device`` (the GPU by default).

    ``lnpost_batch`` maps a (S, ndim) float64 tensor on the device to (S,)
    log-posteriors (``DevicePosterior.lnpost_batch``; the host sampler
    takes a numpy callable instead — that is the API split between the
    two)."""

    def __init__(self, nwalkers: int, ndim: int, lnpost_batch,
                 a: float = 2.0, thin: int = 1, device=None):
        if nwalkers < 2 * ndim or nwalkers % 2:
            raise ValueError(
                "need an even nwalkers >= 2*ndim for ensemble moves")
        self.nwalkers = nwalkers
        self.ndim = ndim
        self.a = float(a)
        self.thin = max(1, int(thin))
        self.device = resolve_device(device)
        self._lnpost_batch = lnpost_batch
        self._chunks: dict = {}      # chunk K -> chunk fn
        self.chain: Optional[np.ndarray] = None
        self.lnprob: Optional[np.ndarray] = None
        self.naccepted = 0
        self.niterations = 0
        self.mode: Optional[str] = None
        self.dispatches = 0          # chunk calls since the last reset

    def reset_dispatch_count(self):
        """Zero ``dispatches`` (bench repeats)."""
        self.dispatches = 0

    def _chunk(self, k: int):
        if k not in self._chunks:
            self._chunks[k] = build_stretch_chunk(
                self._lnpost_batch, self.nwalkers, self.ndim, k,
                thin=self.thin if k > 1 else 1, a=self.a)
        return self._chunks[k]

    def run_mcmc(self, p0: np.ndarray, nsteps: int, seed: int = 0,
                 mode: str = "scan",
                 progress: bool = False) -> np.ndarray:
        """Run the ensemble; returns the final (W, ndim) positions and
        stores the thinned chain in ``self.chain``. ``seed`` anchors the
        positional random streams (identical across modes)."""
        pos = np.array(p0, dtype=np.float64)
        if pos.shape != (self.nwalkers, self.ndim):
            raise ValueError(f"p0 must be {(self.nwalkers, self.ndim)}")
        if nsteps % self.thin:
            raise ValueError("nsteps must be a multiple of thin")
        if nsteps < 1 or nsteps >= 2 ** 31:
            raise ValueError("nsteps must be in [1, 2^31)")
        if mode == "host_loop":
            k = 1
        elif mode == "scan":
            k = config.chain_chunk_steps(nsteps, thin=self.thin)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        dev = self.device
        pos_t = torch.as_tensor(pos, device=dev)
        lp_t = self._lnpost_batch(pos_t)
        if not bool(torch.any(torch.isfinite(lp_t))):
            raise ValueError("no walker starts at finite posterior")
        seed_t = torch.tensor(int(seed), dtype=torch.int64, device=dev)
        chains, lnps = [], []
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        done = 0
        while done < nsteps:
            # the short last chunk is built at its own size: the random
            # streams are positional, so the chain is the same bit for
            # bit, and no step past the end is evaluated
            budget = int(min(k, nsteps - done))
            pos_t, lp_t, acc, chain, lnp = self._chunk(budget)(
                pos_t, lp_t, seed_t, budget, done)
            self.dispatches += 1
            accepted = accepted + acc
            chains.append(chain)
            lnps.append(lnp)
            done += budget
            self.niterations += budget * self.nwalkers
            if progress:
                acc_frac = int(accepted) / (done * self.nwalkers)
                print(f"  chunk done: {done}/{nsteps} acc={acc_frac:.2f}")
        self.naccepted += int(accepted)
        self.chain = torch.cat(chains).cpu().numpy()
        self.lnprob = torch.cat(lnps).cpu().numpy()
        if mode == "host_loop" and self.thin > 1:
            # the K=1 chunk emits every step; thin on the host so both
            # modes return the same (nsteps//thin, W, ndim) chain (scan
            # rows are the state after each thin block)
            self.chain = self.chain[self.thin - 1::self.thin]
            self.lnprob = self.lnprob[self.thin - 1::self.thin]
        return pos_t.cpu().numpy()
