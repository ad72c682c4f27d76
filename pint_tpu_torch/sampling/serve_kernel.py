"""Batched posterior chains over stacked pulsar problems (a port of
pint_tpu/sampling/serve_kernel.py, without the serve layer).

Each batch slot samples the LINEARIZED timing posterior of one pulsar's
``parallel.pta.PulsarProblem`` — the exact Gaussian whose mean and
covariance the batch GLS solve reports (bases marginalized by the same
masked algebra as ``pta._solve_one``) — with the stretch-move chunk of
``sampling.kernel``. Every slot of the padded (P, ...) batch runs at once.

Per slot:

1. the marginal precision A and rhs b of the scaled parameter block, by
   Schur-complementing the noise-basis block out of the masked normal
   matrix (``posterior_system``; identical scaling and pinning to
   ``_solve_one``, so padded rows and columns are inert);
2. W walkers around the GLS solution, overdispersed by 2 marginal sigmas
   (padded parameter dims pinned to exactly 0 — stretch moves between
   zeros stay zero, and the Hastings factor uses the REAL dimension
   count sum(pvalid));
3. the chain, with a per-slot step budget and a per-slot seed (a slot's
   draws depend only on its own seed, never on its batch position);
4. the thinned chain mapped back to physical parameter units (the
   ``dparams`` convention of ``_solve_one``: the correction to ADD).

Oracle: the chain's sample mean and covariance converge on the GLS
``dparams``/``cov``; chunked chains are bitwise the unchunked chain.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.gls import cho_factor, cho_solve, jacobi
from pint_tpu_torch.parallel.pta import STACK_KEYS, _assemble_normal, \
    _outer, stack_problems, upload
from pint_tpu_torch.sampling.kernel import build_stretch_chunk, normals

__all__ = ["make_posterior_slot", "posterior_chunk_driver",
           "posterior_system", "sample_problems"]

# the walkers' start draws: step 0 of streams 6 and 7 (a step's moves
# use streams 0-5)
_INIT_STREAM = 6


def posterior_system(M, F, phi, r, nvec, valid, pvalid) -> dict:
    """The linearized posterior of every slot of a (P, ...) batch:
    ``A`` (P, p, p) the marginal precision and ``bn`` (P, p) the rhs of
    the scaled parameters, ``xhat`` and ``sig`` their mean and marginal
    sigmas, ``scale`` (P, p) the map to physical ``dparams`` units and
    ``ndim`` (P,) the real dimension counts."""
    p = M.shape[-1]
    q = F.shape[-1]
    Sigma, b, _, colmax, norm = _assemble_normal(
        M, F, phi, r, nvec, valid, pvalid)
    # Schur-complement the basis block out: A = Spp - SpF Sff^-1 SFp
    Spp = Sigma[..., :p, :p]
    if q:
        SpF = Sigma[..., :p, p:]
        SFF = Sigma[..., p:, p:]
        dF = jacobi(SFF)
        LF = cho_factor(SFF / _outer(dF))
        X = cho_solve(LF, SpF.mT / dF[..., :, None]) / dF[..., :, None]
        A = Spp - SpF @ X
        bn = b[..., :p] - (X.mT @ b[..., p:, None])[..., 0]
    else:
        A = Spp
        bn = b[..., :p]
    # re-pin padded dims (the Schur step preserves the pinning, this
    # keeps it exact against rounding)
    A = A * _outer(pvalid) + torch.diag_embed(1.0 - pvalid)
    bn = bn * pvalid
    d = jacobi(A)
    L = cho_factor(A / _outer(d))
    xhat = cho_solve(L, bn / d) / d
    eye = torch.eye(p, dtype=A.dtype, device=A.device).expand(A.shape)
    inv = cho_solve(L, eye) / _outer(d)
    sig = torch.sqrt(torch.abs(torch.diagonal(inv, dim1=-2, dim2=-1)))
    return {"A": A, "bn": bn, "xhat": xhat, "sig": sig,
            "scale": -pvalid / (colmax * norm), "pvalid": pvalid,
            "ndim": torch.sum(pvalid, dim=-1)}


def make_posterior_slot(W: int, K: int, thin: int = 1,
                        a: float = 2.0, scatter: float = 2.0):
    """The chunk function of a batch of posterior slots:

        one(system, seeds, budget, pos_in, lp_in, init, offset)
            -> (pos, lp, naccept, chain_phys, lnprob)

    ``system`` is ``posterior_system``'s dict, ``seeds`` and ``budget``
    int64 (P,) tensors; with ``init`` the walkers start afresh around the
    GLS solution (chunk 0), else from the carried (pos_in, lp_in)."""

    def one(system, seeds, budget, pos_in, lp_in, init: bool,
            offset: int):
        A, bn = system["A"], system["bn"]

        def logp_batch(x):
            # exact Gaussian log-density of the linearized posterior
            # (constant dropped: MH only consumes differences)
            return -0.5 * torch.sum((x @ A) * x, dim=-1) + \
                torch.sum(x * bn[..., None, :], dim=-1)

        chunk = build_stretch_chunk(logp_batch, W, system["ndim"], K,
                                    thin=thin, a=a)
        if init:
            p = A.shape[-1]
            z = normals(seeds, 0, _INIT_STREAM, W * p)
            z = z.reshape(z.shape[:-1] + (W, p))
            pos = (system["xhat"][..., None, :] + scatter *
                   system["sig"][..., None, :] * z) * \
                system["pvalid"][..., None, :]
            lp = logp_batch(pos)
        else:
            pos, lp = pos_in, lp_in
        pos, lp, nacc, chain, lnp = chunk(pos, lp, seeds, budget, offset)
        # physical units, dparams sign convention (correction to ADD)
        return pos, lp, nacc, chain * system["scale"][..., None, None, :], \
            lnp

    return one


def posterior_chunk_driver(fnv, stacked: dict, seeds, nsteps,
                           W: int, K: int, thin: int, device=None,
                           sync: bool = True, progress=None,
                           supervisor=None,
                           key_tag: str = "sampling.post_direct",
                           pool: str = "device",
                           info: Optional[dict] = None):
    """Drive one padded batch through its chunks and return per-slot
    results.

    ``fnv`` is ``make_posterior_slot``'s function; ``seeds``/``nsteps``
    are per slot. Each chunk is its OWN supervised dispatch (key
    ``<key_tag>/chunk<c>``, on ``supervisor``, the process-global one by
    default) on ``device``: the problem batch goes there once and its
    posterior system is built once, the ensemble state (pos, lp) comes
    back to the host after every chunk, and a device that dies mid-chain
    fails the chunk over to the same chunk on the CPU, continuing from
    the carried state — labelled in ``info['used_pool']`` ("device",
    "host" or "host-failover"). ``pool="host"`` runs every chunk on the
    CPU, pinned. ``progress`` (steps completed per slot) fires after
    each chunk. Returns a zero-arg ``collect``; its call yields (chain
    (P, S_total, W, p), lnprob, naccept (P,), rows_done (P,)) host
    arrays. ``sync=False`` issues chunk 0 on the supervisor's async
    path; ``collect`` runs the rest."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.runtime import get_supervisor

    if supervisor is None:
        supervisor = get_supervisor()
    if info is None:
        info = {}
    info.setdefault("pool", pool)
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    P = stacked["M"].shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    nsteps = np.asarray(nsteps, dtype=np.int64)
    kmax = int(nsteps.max()) if len(nsteps) else 0
    nchunks = max(1, -(-kmax // K))
    budgets = np.clip(nsteps[None, :] - K * np.arange(nchunks)[:, None],
                      0, K)
    fell_over: List[bool] = []
    # the problem batch, its posterior system, the seeds and budgets,
    # placed ONCE per device; a failover builds the CPU copy from the
    # host arrays, never from the device's
    placed: dict = {}

    def system_on(d):
        if str(d) not in placed:
            ints = torch.from_numpy(np.concatenate(
                [seeds, budgets.ravel()])).to(d)
            st = upload(stacked, STACK_KEYS, d)
            placed[str(d)] = (posterior_system(*(st[k] for k in STACK_KEYS)),
                              ints[:P], ints[P:].view(nchunks, P))
        return placed[str(d)]

    def closures(c, pos_h, lp_h):
        def call(d):
            system, seeds_t, budgets_t = system_on(d)
            pos = lp = None
            if c:
                pos, lp = pos_h.to(d), lp_h.to(d)
            return fnv(system, seeds_t, budgets_t[c], pos, lp, c == 0,
                       c * K)

        def run_pinned():
            return call(cpu)

        def host_counted():
            fell_over.append(True)
            return run_pinned()  # graftlint: allow G6 -- inside the host failover the supervisor itself runs (fallback=host_counted): the same chunk on the CPU

        return (lambda: call(dev)), run_pinned, host_counted

    def issue(c, pos_h, lp_h, asynchronous=False):
        run, run_pinned, host_counted = closures(c, pos_h, lp_h)
        key = f"{key_tag}/chunk{c}"
        if pool == "host":
            return supervisor.dispatch(run_pinned, key=key, steps=K,
                                       pinned=True)
        if asynchronous:
            return supervisor.dispatch_async(
                run, key=key, steps=K, fallback=host_counted, device=dev)
        return supervisor.dispatch(run, key=key, steps=K,
                                   fallback=host_counted, device=dev)

    def drain(first):
        pos = lp = None
        acc = np.zeros(P, np.int64)
        rows_done = np.zeros(P, np.int64)
        chains: List[np.ndarray] = []
        lnps: List[np.ndarray] = []
        for c in range(nchunks):
            with obs.span("posterior.chunk", chunk=c, steps=K, pool=pool):
                out = first.result() if c == 0 and first is not None \
                    else issue(c, pos, lp)
            # the carried state on the host: a later chunk's failover
            # continues from it without reading the device
            pos, lp, nacc, chain, lnp = (x.cpu() for x in out)
            acc += nacc.numpy()
            chains.append(chain.numpy())
            lnps.append(lnp.numpy())
            rows_done += budgets[c] // thin
            if progress is not None:
                progress(np.minimum(nsteps, (c + 1) * K))
        info["used_pool"] = "host" if pool == "host" else \
            ("host-failover" if fell_over else "device")
        return _gather(np.concatenate(chains, axis=1),
                       np.concatenate(lnps, axis=1), acc, rows_done)

    def _gather(chain, lnp, acc, rows_done):
        """Per-slot row gather: chunk c's valid rows for slot k are its
        first budget_ck//thin emitted rows (later rows repeat the final
        state under the budget mask)."""
        S = K // thin
        rows_total = int(rows_done.max()) if P else 0
        pb = chain.shape[-1]
        chain_out = np.zeros((P, rows_total, W, pb))
        lnp_out = np.zeros((P, rows_total, W))
        for k in range(P):
            got = 0
            for c in range(nchunks):
                nkeep = int(budgets[c, k]) // thin
                if nkeep == 0:
                    break
                sl = slice(c * S, c * S + nkeep)
                chain_out[k, got:got + nkeep] = chain[k, sl]
                lnp_out[k, got:got + nkeep] = lnp[k, sl]
                got += nkeep
        return chain_out, lnp_out, acc, rows_done

    if sync or pool == "host":
        return lambda: drain(None)
    with obs.span("posterior.chunk.issue", chunk=0, steps=K):
        first = issue(0, None, None, asynchronous=True)
    return lambda: drain(first)


def sample_problems(problems: Sequence, nwalkers: int, nsteps: int,
                    seeds: Sequence[int], thin: int = 1,
                    shape=None, chunk: Optional[int] = None, device=None):
    """Batched posterior sampling of every problem at once, on ``device``
    (the GPU by default): pad ``problems`` to ``shape`` ((P, N, p, q),
    defaults to the batch maxima), run every slot's chain, and return
    per-problem (chain (S, W, p_real), lnprob, acceptance_fraction)."""
    from pint_tpu_torch import config

    problems = list(problems)
    W = int(nwalkers)
    for pr in problems:
        # the slot kernel takes ndim as a tensor, so build_stretch_chunk
        # cannot check this — an under-walkered stretch ensemble
        # silently never leaves the affine hull of its start positions
        if W % 2 or W < 2 * pr.M.shape[1]:
            raise ValueError(
                f"nwalkers={W} too small for a {pr.M.shape[1]}-dim "
                "problem: need an even nwalkers >= 2*ndim")
    stacked = stack_problems(problems, shape=shape)
    P = stacked["M"].shape[0]
    K = int(chunk) if chunk else config.chain_chunk_steps(
        nsteps, thin=thin)
    fnv = make_posterior_slot(W, K, thin=thin)
    seeds = list(seeds) + [0] * (P - len(problems))
    nsteps_arr = [nsteps] * len(problems) + [0] * (P - len(problems))
    collect = posterior_chunk_driver(fnv, stacked, seeds, nsteps_arr, W,
                                     K, thin, device=device)
    chain, lnp, acc, rows = collect()
    out = []
    for k, pr in enumerate(problems):
        p = pr.M.shape[1]
        nrows = int(rows[k])
        out.append((np.ascontiguousarray(chain[k, :nrows, :, :p]),
                    lnp[k, :nrows].copy(),
                    float(acc[k]) / max(1, int(nsteps) * W)))
    return out
