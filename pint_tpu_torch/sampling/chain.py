"""DeviceEnsembleSampler: whole chains run in chunks on the device (a
port of pint_tpu/sampling/chain.py).

Reference: src/pint/sampler.py (EmceeSampler) — the same stretch-move
ensemble as ``pint_tpu_torch.sampler.EnsembleSampler``, but the walkers'
moves, their log-posteriors and the random draws run on the device: each
chunk of K steps (``sampling.kernel.build_stretch_chunk``, K from
``config.chain_chunk_steps``) is one supervised dispatch (key
``sampling.chain``; the starting log-posteriors ``sampling.lnpost0``).
The ensemble state (pos, lp) comes back to the host after each chunk,
as in the reference, so a chunk that fails (a wedge, a lost device, an
open breaker) re-runs on the CPU from the carried state: the same chunk
with ``host_lnpost_batch``, the posterior on the CPU (on a CPU sampler,
``lnpost_batch`` itself). Without one a failed chunk raises the labelled
``DispatchError``.

Modes:

- ``mode="scan"`` (default): ceil(nsteps/K) chunks;
- ``mode="host_loop"``: the SAME chunk built at K=1, one call per step.
  The random streams are positional (a hash of the seed and the global
  step), so the two modes draw identical numbers and give the same chain
  bit for bit — host_loop is the oracle of the chunking.

Health ($PINT_TPU_HEALTH, ``obs.health``): each chunk's walker
log-posteriors and acceptance count, already returned by its dispatch,
are observed as ``posterior.chunk`` (no extra dispatch), attributed to
the pool that produced them (``host`` after a failover).
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
    two). ``host_lnpost_batch`` is the same function on the CPU, the
    chunks' failover (module docstring)."""

    def __init__(self, nwalkers: int, ndim: int, lnpost_batch,
                 a: float = 2.0, thin: int = 1, device=None,
                 host_lnpost_batch=None):
        from pint_tpu_torch.obs import metrics as om

        if nwalkers < 2 * ndim or nwalkers % 2:
            raise ValueError(
                "need an even nwalkers >= 2*ndim for ensemble moves")
        self.nwalkers = nwalkers
        self.ndim = ndim
        self.a = float(a)
        self.thin = max(1, int(thin))
        self.device = resolve_device(device)
        self._lnpost_batch = lnpost_batch
        if host_lnpost_batch is None and self.device.type == "cpu":
            host_lnpost_batch = lnpost_batch
        self._host_lnpost_batch = host_lnpost_batch
        self._chunks: dict = {}      # (K, on the host) -> chunk fn
        self.chain: Optional[np.ndarray] = None
        self.lnprob: Optional[np.ndarray] = None
        self.naccepted = 0
        self.niterations = 0
        self.mode: Optional[str] = None
        # supervised chunk dispatches, registry-backed: ``dispatches``
        # is a derived view of the bound counter child
        self._c_dispatches = om.counter(
            "pint_tpu_chain_dispatches_total",
            "whole-chain-on-device chunk dispatches"
        ).child(scope=om.new_scope("chain"))
        self._dispatch_base = 0

    @property
    def dispatches(self) -> int:
        """Chunk dispatches since the last ``reset_dispatch_count``."""
        return int(self._c_dispatches.value()) - self._dispatch_base

    def reset_dispatch_count(self):
        """Zero ``dispatches`` (bench repeats); the registry counter
        stays monotonic."""
        self._dispatch_base = int(self._c_dispatches.value())

    def _chunk(self, k: int, host: bool = False):
        if (k, host) not in self._chunks:
            fn = self._host_lnpost_batch if host else self._lnpost_batch
            self._chunks[k, host] = build_stretch_chunk(
                fn, self.nwalkers, self.ndim, k,
                thin=self.thin if k > 1 else 1, a=self.a)
        return self._chunks[k, host]

    def _fallback(self, fn):
        """``fn`` as a dispatch's host failover, or None without a CPU
        posterior."""
        return fn if self._host_lnpost_batch is not None else None

    def _initial_lp(self, pos: np.ndarray) -> torch.Tensor:
        """(W,) log-posteriors of the starting walkers, one supervised
        dispatch (``sampling.lnpost0``), on the host."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import get_supervisor

        def run():
            return self._lnpost_batch(torch.as_tensor(pos,
                                                      device=self.device))

        def run_pinned():
            return self._host_lnpost_batch(torch.as_tensor(pos))

        with obs.span("sampling.lnpost0"):
            return get_supervisor().dispatch(
                run, key="sampling.lnpost0", device=self.device,
                fallback=self._fallback(run_pinned)).cpu()

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
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import get_supervisor

        sup = get_supervisor()
        dev = self.device
        # the carried ensemble state, on the host between chunks
        pos_h = torch.as_tensor(pos)
        lp_h = self._initial_lp(pos)
        if not bool(torch.any(torch.isfinite(lp_h))):
            raise ValueError("no walker starts at finite posterior")
        chains, lnps = [], []
        accepted = 0
        done = 0
        while done < nsteps:
            # the short last chunk is built at its own size: the random
            # streams are positional, so the chain is the same bit for
            # bit, and no step past the end is evaluated
            budget = int(min(k, nsteps - done))

            def call(d, host, pos_h=pos_h, lp_h=lp_h, budget=budget,
                     off=done):
                seed_t = torch.tensor(int(seed), dtype=torch.int64,
                                      device=d)
                return self._chunk(budget, host)(
                    pos_h.to(d), lp_h.to(d), seed_t, budget, off)

            def run_pinned(call=call):
                # the SAME chunk on the CPU, from the carried state
                return call(torch.device("cpu"), True)  # graftlint: allow G6 -- inside the fallback the supervisor runs: the same chunk on the CPU posterior from the carried state, no card

            with obs.span("sampling.chunk", steps=budget):
                dinfo: dict = {}
                out = sup.dispatch(call, dev, False, key="sampling.chain",
                                   steps=budget, device=dev,
                                   fallback=self._fallback(run_pinned),
                                   info=dinfo)
                pos_h, lp_h, acc, chain, lnp = (x.cpu() for x in out)
                # NaN/+inf log-posteriors are the incident class (-inf
                # is a legal parked walker); the acceptance fraction is
                # a gauge only: healthy ensembles range widely
                from pint_tpu_torch.obs import health as _health

                _health.observe(
                    "posterior.chunk",
                    {"lnpost": lp_h.numpy(),
                     "accept_frac": float(acc)
                     / max(1, budget * self.nwalkers)},
                    pool="host" if dinfo.get("failover") else "device",
                    key="sampling.chain")
            self._c_dispatches.inc()
            accepted += int(acc)
            chains.append(chain)
            lnps.append(lnp)
            done += budget
            self.niterations += budget * self.nwalkers
            if progress:
                acc_frac = accepted / (done * self.nwalkers)
                print(f"  chunk done: {done}/{nsteps} acc={acc_frac:.2f}")
        self.naccepted += accepted
        self.chain = torch.cat(chains).numpy()
        self.lnprob = torch.cat(lnps).numpy()
        if mode == "host_loop" and self.thin > 1:
            # the K=1 chunk emits every step; thin on the host so both
            # modes return the same (nsteps//thin, W, ndim) chain (scan
            # rows are the state after each thin block)
            self.chain = self.chain[self.thin - 1::self.thin]
            self.lnprob = self.lnprob[self.thin - 1::self.thin]
        return pos_h.numpy()
