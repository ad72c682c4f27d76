"""Chi-squared grids over frozen parameter sets (a port of
pint_tpu/gridutils.py; reference: src/pint/gridutils.py grid_chisq,
grid_chisq_derived).

The reference refits the model at every grid node in a process pool.
Here the gridded parameters are frozen, the fit step over the remaining
free parameters is built once (``parallel.build_fit_step``), and
``torch.func.vmap`` of ``maxiter`` refit iterations runs over the nodes
on the model's device — in chunks of ``config.grid_chunk`` nodes, so the
working set of a chunk (the refit step's jacfwd tangents: ~50 MB a node
at 10,000 TOAs and 39 columns on an H100, PERF.md) fits a stated memory
budget. Every node is computed alone inside the vmapped batch, so the
chunking changes no bit of the result.

The refit step takes the precision routes from their environment
variables ($PINT_TPU_ANCHORED, $PINT_TPU_JAC, $PINT_TPU_GLS_MATMUL). The
gridded parameters vary through the step's frozen slots, which the
anchored route reads as deltas against its anchor, so an anchored grid
is the direct grid's surface, not the build point's.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["grid_chisq", "grid_chisq_derived"]


def _build_grid_eval(model, toas, parnames: Sequence[str], maxiter: int):
    """(eval_fn, nparams): eval_fn maps a (G,) tensor of gridded-parameter
    values to the refit chi2 (vmap-ready), nparams the step's columns."""
    from pint_tpu_torch.parallel.fit_step import build_fit_step

    m = copy.deepcopy(model)
    for name in parnames:
        p = m.get_param(name)
        if p.value is None:
            raise ValueError(f"{name} has no value to grid around")
        p.frozen = True
    m.invalidate_cache()
    # an empty remaining-free set is fine: the implicit Offset column is
    # always profiled, so the step still returns a meaningful chi2
    step_fn, args, names = build_fit_step(m, toas)
    noff = 1 if names and names[0] == "Offset" else 0
    th0, tl0, fh0, fl0 = args[:4]
    frozen_names = m._pack()[1]
    gidx = torch.as_tensor([frozen_names.index(nm) for nm in parnames],
                           device=fh0.device)
    # grid values are absolute: zero the dd low part too, else a fitted
    # parameter's residual lo (~eps*value, e.g. ~0.1 sigma for F0)
    # silently shifts every node off its nominal coordinate
    fl_z = fl0.index_put((gidx,), torch.zeros_like(gidx, dtype=fl0.dtype))

    def eval_node(gvals):
        fh = fh0.index_put((gidx,), gvals)

        def one_iter(th):
            dparams, _, chi2, _ = step_fn(th, tl0, fh, fl_z, *args[4:])[:4]
            # drop the Offset column when present; the rest align with
            # th (PHOFF models have no implicit offset column)
            return th + dparams[noff:], chi2

        th = th0
        for _ in range(maxiter):
            th, _ = one_iter(th)
        return one_iter(th)[1]  # chi2 at the refit point

    return eval_node, len(names)


def _eval_nodes(model, toas, parnames, nodes: np.ndarray,
                maxiter: int) -> np.ndarray:
    """The refit chi2 at every row of ``nodes`` (S, G), vmapped over
    chunks of ``config.grid_chunk`` nodes."""
    from pint_tpu_torch import config

    eval_node, nparams = _build_grid_eval(model, toas, parnames, maxiter)
    k = config.grid_chunk(toas.ntoas, nparams)
    nodes_t = torch.as_tensor(nodes, dtype=torch.float64,
                              device=model.device)
    batch = torch.func.vmap(eval_node)
    out = [batch(nodes_t[i:i + k]) for i in range(0, len(nodes_t), k)]
    return torch.cat(out).cpu().numpy()


def grid_chisq(model, toas, parnames: Sequence[str],
               parvalues: Sequence[np.ndarray],
               maxiter: int = 2) -> np.ndarray:
    """chi2 over the outer-product grid of ``parvalues`` with the
    parameters in ``parnames`` held fixed at each node and every other
    free parameter refit (reference: gridutils.grid_chisq), on the
    model's device, ``config.grid_chunk`` nodes at a time.

    Returns an array of shape (len(parvalues[0]), len(parvalues[1]),
    ...) matching np.meshgrid(..., indexing='ij').
    """
    if len(parnames) != len(parvalues):
        raise ValueError("parnames and parvalues must pair up")
    grids = [np.asarray(v, dtype=np.float64) for v in parvalues]
    mesh = np.meshgrid(*grids, indexing="ij")
    nodes = np.stack([g.ravel() for g in mesh], axis=1)  # (S, G)
    chi2 = _eval_nodes(model, toas, parnames, nodes, maxiter)
    return chi2.reshape(mesh[0].shape)


def grid_chisq_derived(model, toas, parnames: Sequence[str],
                       parfuncs: Sequence[Callable],
                       gridvalues: Sequence[np.ndarray],
                       maxiter: int = 2) -> Tuple[np.ndarray, list]:
    """Grid over derived quantities: ``parfuncs[k](*grid_coords)``
    gives the value of ``parnames[k]`` at each node (reference:
    gridutils.grid_chisq_derived). Returns (chi2, [param value arrays])."""
    if not (len(parnames) == len(parfuncs) == len(gridvalues)):
        raise ValueError("parnames, parfuncs, gridvalues must pair up")
    grids = [np.asarray(v, dtype=np.float64) for v in gridvalues]
    mesh = np.meshgrid(*grids, indexing="ij")
    pvals = [np.asarray(f(*mesh), dtype=np.float64) for f in parfuncs]
    nodes = np.stack([v.ravel() for v in pvals], axis=1)
    chi2 = _eval_nodes(model, toas, parnames, nodes, maxiter)
    return chi2.reshape(mesh[0].shape), pvals
