"""PTA-scale batch fitting: one batched GLS solve across many pulsars (a
port of pint_tpu/parallel/pta.py).

Each pulsar's linearized GLS problem (design matrix, residuals, noise
basis) is padded to a common (N_max, p_max, q_max) shape and the whole
batch is solved at once: every function below works on (P, ...) tensors,
the pulsar axis leading, and torch.linalg factors the P normal matrices
as one batch (BASELINE.md config #5).

With a device mesh (``pta.shard.Mesh``) ``pta_solve`` and ``fit_pta``
split the pulsar axis into contiguous per-device blocks, each solved on
its device, and gather them in block order.

Ragged shapes are handled with validity masks: padded TOA rows carry
zero weight, padded parameter columns are identity-pinned in the normal
matrix, padded basis columns get unit prior and zero data weight.

The host pieces (``PulsarProblem``, ``stack_problems``, the numpy mirrors
``_solve_one_np``/``pta_solve_np``) are copies of the reference's.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.gls import cho_factor, cho_solve, jacobi
from pint_tpu_torch.residuals import Residuals

__all__ = ["PulsarProblem", "build_problem", "stack_problems",
           "pta_solve", "pta_solve_np", "fit_pta", "PTAFitResult"]

STACK_KEYS = ("M", "F", "phi", "r", "nvec", "valid", "pvalid")
# ranks of the batch solve's outputs (checked by its block plan)
_PTA_NDIMS_OUT = (2, 3, 1, 1)


class PTAFitResult(list):
    """fit_pta's return: a list of per-pulsar results carrying the
    aggregate timing scoreboard in ``.stats``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.stats: dict = {}


class PulsarProblem:
    """One pulsar's linearized GLS inputs (host, unpadded)."""

    def __init__(self, M, r, nvec, F, phi, names, model=None, toas=None):
        self.M = np.asarray(M)
        self.r = np.asarray(r)
        self.nvec = np.asarray(nvec)
        self.F = np.asarray(F)
        self.phi = np.asarray(phi)
        self.names = list(names)
        self.model = model
        self.toas = toas


def build_problem(toas, model, track_mode=None) -> PulsarProblem:
    """Assemble the linearized problem at the model's current point: the
    residuals and the design matrix are evaluated on the model's device
    and brought to the host."""
    res = Residuals(toas, model, track_mode=track_mode)
    M, names, _ = model.designmatrix(toas, incoffset=True)
    nvec = model.scaled_toa_uncertainty(toas) ** 2
    F = model.noise_model_designmatrix(toas)
    phi = model.noise_model_basis_weight(toas)
    if F is None:
        F = np.zeros((toas.ntoas, 0))
        phi = np.ones(0)
    return PulsarProblem(M.cpu().numpy(), res.time_resids.cpu().numpy(),
                         nvec, F, phi, names, model=model, toas=toas)


def stack_problems(problems: Sequence[PulsarProblem],
                   shape: Optional[Tuple[int, int, int, int]] = None):
    """Pad every pulsar to the batch maxima and stack:
    returns dict of (P, ...) arrays.

    ``shape`` optionally fixes the padded target (P, N, pmax, qmax) —
    each component must be >= the batch's own maximum. Extra batch slots
    beyond len(problems) are fully padded pulsars (valid = pvalid = 0,
    unit nvec/phi), which the masked solve takes to the identity system
    (dparams 0, chi2 0)."""
    P = len(problems)
    N = max(p.M.shape[0] for p in problems)
    pmax = max(p.M.shape[1] for p in problems)
    qmax = max(p.F.shape[1] for p in problems)
    if shape is not None:
        Pt, Nt, pt, qt = shape
        if Pt < P or Nt < N or pt < pmax or qt < qmax:
            raise ValueError(
                f"target shape {shape} smaller than batch maxima "
                f"({P}, {N}, {pmax}, {qmax})")
        P, N, pmax, qmax = Pt, Nt, pt, qt
    M = np.zeros((P, N, pmax))
    F = np.zeros((P, N, qmax))
    phi = np.ones((P, qmax))
    r = np.zeros((P, N))
    nvec = np.ones((P, N))
    valid = np.zeros((P, N))
    pvalid = np.zeros((P, pmax))
    for k, pr in enumerate(problems):
        n, pp = pr.M.shape
        q = pr.F.shape[1]
        M[k, :n, :pp] = pr.M
        F[k, :n, :q] = pr.F
        phi[k, :q] = pr.phi
        r[k, :n] = pr.r
        nvec[k, :n] = pr.nvec
        valid[k, :n] = 1.0
        pvalid[k, :pp] = 1.0
    return {"M": M, "F": F, "phi": phi, "r": r, "nvec": nvec,
            "valid": valid, "pvalid": pvalid}


def upload(arrs: dict, keys: Sequence[str], device) -> dict:
    """{key: float64 tensor on ``device``} from host arrays, moved in ONE
    host-to-device copy (the tensors are views of one buffer)."""
    host = [np.asarray(arrs[k], dtype=np.float64) for k in keys]
    flat = np.concatenate([h.ravel() for h in host])
    buf = torch.from_numpy(flat).to(device)
    out, o = {}, 0
    for k, h in zip(keys, host):
        out[k] = buf[o:o + h.size].view(h.shape)
        o += h.size
    return out


def read_back(outs: Sequence) -> tuple:
    """The tensors as numpy arrays, moved in ONE device-to-host copy per
    device. An output of a planned call over a mesh (``pta.shard.
    Blocks``) comes back as its blocks concatenated in block order."""
    from pint_tpu_torch.pta.shard import Blocks

    parts = [t for o in outs for t in (o if isinstance(o, Blocks)
                                       else (o,))]
    by_dev: dict = {}
    for i, t in enumerate(parts):
        by_dev.setdefault(t.device, []).append(i)
    host = [None] * len(parts)
    for idx in by_dev.values():
        flat = torch.cat([parts[i].reshape(-1) for i in idx]).cpu().numpy()
        o = 0
        for i in idx:
            n = parts[i].numel()
            host[i] = flat[o:o + n].reshape(tuple(parts[i].shape))
            o += n
    res, k = [], 0
    for o in outs:
        if isinstance(o, Blocks):
            res.append(np.concatenate(host[k:k + len(o)], axis=0))
            k += len(o)
        else:
            res.append(host[k])
            k += 1
    return tuple(res)


def _outer(a):
    """(..., n, n) outer products of a (..., n) batch of vectors."""
    return a[..., :, None] * a[..., None, :]


def _assemble_normal(M, F, phi, r, nvec, valid, pvalid):
    """Masked, column-scaled JOINT (params + bases) normal system of
    each pulsar of the batch (every argument (P, ...), or one pulsar
    without the leading axis) — the one assembly shared by the batch
    solve, the GWB blocks (``pta.gwb``) and the posterior
    (``sampling.serve_kernel``). Returns (Sigma, b, w, colmax, norm)
    with padded parameter columns pinned to identity so Cholesky stays
    PD."""
    w = valid / nvec
    M = M * pvalid[..., None, :]
    colmax = torch.amax(torch.abs(M), dim=-2)
    colmax = torch.where(colmax == 0, torch.ones_like(colmax), colmax)
    Ms = M / colmax[..., None, :]
    norm = torch.sqrt(torch.sum(Ms * Ms * w[..., :, None], dim=-2))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    Mn = Ms / norm[..., None, :]
    big = torch.cat([Mn, F], dim=-1)
    bigw = big * w[..., :, None]
    Sigma = big.mT @ bigw
    prior = torch.cat([torch.zeros_like(pvalid), 1.0 / phi], dim=-1)
    Sigma = Sigma + torch.diag_embed(prior)
    colvalid = torch.cat([pvalid, torch.ones_like(phi)], dim=-1)
    Sigma = Sigma * _outer(colvalid) + torch.diag_embed(1.0 - colvalid)
    b = (bigw.mT @ r[..., :, None])[..., 0] * colvalid
    return Sigma, b, w, colmax, norm


def _solve_one(M, F, phi, r, nvec, valid, pvalid):
    """Masked, preconditioned basis-Woodbury solve of every pulsar of the
    batch (the algebra of ``gls._gls_kernel`` with padding guards).

    Returns (dparams, cov, chi2, chi2r): ``chi2`` is the linearized
    post-fit chi2 (parameters AND bases marginalized); ``chi2r`` is the
    chi2 of the residuals at the CURRENT point with only the noise bases
    marginalized (r^T C^-1 r, what Residuals.chi2 reports). A pulsar
    whose normal matrix is not positive definite gets NaN, the others
    are untouched."""
    p = M.shape[-1]
    Sigma, b, w, colmax, norm = _assemble_normal(
        M, F, phi, r, nvec, valid, pvalid)
    d = jacobi(Sigma)
    dd = _outer(d)
    L = cho_factor(Sigma / dd)
    xhat = cho_solve(L, b / d) / d
    eye = torch.eye(Sigma.shape[-1], dtype=Sigma.dtype,
                    device=Sigma.device).expand(Sigma.shape)
    inv = cho_solve(L, eye) / dd
    rCr = torch.sum(r * r * w, dim=-1)
    chi2 = rCr - torch.sum(xhat * b, dim=-1)
    # bases-only marginalization: whiten by the noise block alone so
    # chi2r is r^T C^-1 r at the current point; on an all-padded slot
    # the basis block is the identity and chi2r collapses to 0
    q = F.shape[-1]
    if q:
        bF = b[..., p:]
        dF = d[..., p:]
        LF = cho_factor(Sigma[..., p:, p:] / _outer(dF))
        chi2r = rCr - torch.sum(bF * (cho_solve(LF, bF / dF) / dF), dim=-1)
    else:
        chi2r = rCr
    dparams = -xhat[..., :p] / colmax / norm * pvalid
    cov = inv[..., :p, :p] / _outer(colmax) / _outer(norm)
    return dparams, cov, chi2, chi2r


def _solve_one_np(M, F, phi, r, nvec, valid, pvalid):
    """Pure-numpy mirror of ``_solve_one`` for one slot (identical
    masked algebra, scipy Cholesky): the CPU oracle of the batch
    solve."""
    from scipy.linalg import cho_factor, cho_solve

    p = M.shape[1]
    w = valid / nvec
    M = M * pvalid[None, :]
    colmax = np.max(np.abs(M), axis=0)
    colmax = np.where(colmax == 0, 1.0, colmax)
    Ms = M / colmax[None, :]
    norm = np.sqrt(np.sum(Ms * Ms * w[:, None], axis=0))
    norm = np.where(norm == 0, 1.0, norm)
    Mn = Ms / norm[None, :]
    big = np.concatenate([Mn, F], axis=1)
    bigw = big * w[:, None]
    Sigma = big.T @ bigw
    prior = np.concatenate([np.zeros(p), 1.0 / phi])
    Sigma = Sigma + np.diag(prior)
    colvalid = np.concatenate([pvalid, np.ones(F.shape[1])])
    Sigma = Sigma * np.outer(colvalid, colvalid) + \
        np.diag(1.0 - colvalid)
    b = bigw.T @ r * colvalid
    d = np.sqrt(np.diagonal(Sigma)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    cf = cho_factor(Sigma / np.outer(d, d), lower=True)
    xhat = cho_solve(cf, b / d) / d
    inv = cho_solve(cf, np.eye(Sigma.shape[0])) / np.outer(d, d)
    rCr = float(np.sum(r * r * w))
    chi2 = rCr - xhat @ b
    q = F.shape[1]
    if q:
        bF = b[p:]
        SF = Sigma[p:, p:]
        dF = d[p:]
        cfF = cho_factor(SF / np.outer(dF, dF), lower=True)
        chi2r = rCr - bF @ (cho_solve(cfF, bF / dF) / dF)
    else:
        chi2r = rCr
    dparams = -xhat[:p] / colmax / norm * pvalid
    cov = inv[:p, :p] / np.outer(colmax, colmax) / np.outer(norm, norm)
    return dparams, cov, float(chi2), float(chi2r)


def pta_solve_np(stacked: dict):
    """Host batch solve: ``_solve_one_np`` per slot, stacked."""
    P = stacked["M"].shape[0]
    outs = [_solve_one_np(stacked["M"][k], stacked["F"][k],
                          stacked["phi"][k], stacked["r"][k],
                          stacked["nvec"][k], stacked["valid"][k],
                          stacked["pvalid"][k])
            for k in range(P)]
    return (np.stack([o[0] for o in outs]),
            np.stack([o[1] for o in outs]),
            np.asarray([o[2] for o in outs]),
            np.asarray([o[3] for o in outs]))


def pta_solve(stacked: dict, device=None, mesh=None,
              axis: str = "pulsar"):
    """Solve the whole stacked batch on ``device`` (the GPU by default):
    one upload, one batched solve, one read back, as one supervised
    dispatch (key ``pta.batch``) whose host failover is
    ``pta_solve_np``. Returns host (dparams (P, p), cov (P, p, p), chi2
    (P,), chi2r (P,)). A slot whose normal matrix is not positive
    definite comes back NaN, as the reference's compiled solve gives
    it.

    With ``mesh`` (``pta.shard.Mesh``) the batch, padded to a multiple
    of the mesh's ``axis`` (``pad_batch``), is split into contiguous
    per-device blocks of pulsars (``compile_with_plan``): one upload per
    block, the solve issued on every block on its device, then the read
    back; ``device`` is not used, and the dispatch rides the breaker of
    the mesh's first device. The first P rows come back."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.pta.shard import mesh_devices, run_batch
    from pint_tpu_torch.runtime import get_supervisor

    dev = resolve_device(device) if mesh is None else \
        mesh_devices(mesh, axis)[0]

    def run():
        return run_batch(_solve_one, stacked, STACK_KEYS,
                         name="pta.batch_solve", ndims_out=_PTA_NDIMS_OUT,
                         mesh=mesh, axis=axis, device=dev)

    with obs.span("pta.solve", npulsars=len(stacked["M"]),
                  sharded=mesh is not None):
        return get_supervisor().dispatch(
            run, key="pta.batch", device=dev,
            fallback=lambda: pta_solve_np(stacked))


def fit_pta(pairs: Sequence[Tuple], maxiter: int = 2, mesh=None,
            track_mode=None, device=None,
            axis: str = "pulsar") -> List[dict]:
    """Batch-fit [(toas, model), ...]: each iteration assembles every
    pulsar's linearized problem (``build_problem``, on each model's
    device), then solves ALL of them in one batched call on ``device``
    and applies the updates. Returns a PTAFitResult (a list of per-pulsar
    {chi2, errors}; models updated in place) whose ``.stats`` attribute
    is the scoreboard: total TOAs, wall time, TOAs/sec, device solve
    time and the seconds spent building problems. ``fit_pta.last_stats``
    mirrors it (last call wins). With ``mesh`` each solve is split
    over the mesh's ``axis`` (``pta_solve``)."""
    if mesh is not None:
        from pint_tpu_torch.pta.shard import mesh_devices

        mesh_devices(mesh, axis)
    t_start = time.perf_counter()
    solve_s = build_s = 0.0

    def solve_all():
        nonlocal solve_s, build_s
        t0 = time.perf_counter()
        problems = [build_problem(t, m, track_mode=track_mode)
                    for t, m in pairs]
        build_s += time.perf_counter() - t0
        stacked = stack_problems(problems)
        t0 = time.perf_counter()
        out = pta_solve(stacked, device=device, mesh=mesh, axis=axis)
        solve_s += time.perf_counter() - t0
        return problems, out

    for _ in range(max(1, maxiter)):
        problems, (dparams, _, _, _) = solve_all()
        for k, pr in enumerate(problems):
            x = dparams[k][:len(pr.names)]
            for name, dx in zip(pr.names, x):
                if name == "Offset":
                    continue
                pr.model.get_param(name).add_delta(float(dx))
            pr.model.invalidate_cache(params_only=True)
    # final pass: uncertainties + chi2 at the fitted point
    problems, (_, cov, chi2, _) = solve_all()
    out: List[dict] = []
    for k, pr in enumerate(problems):
        errs = {}
        sig = np.sqrt(np.diag(cov[k]))
        for j, name in enumerate(pr.names):
            if name == "Offset":
                continue
            pr.model.get_param(name).uncertainty = float(sig[j])
            errs[name] = float(sig[j])
        out.append({"chi2": float(chi2[k]), "errors": errs})
    wall = time.perf_counter() - t_start
    ntoa_total = sum(t.ntoas for t, _ in pairs)
    niter = max(1, maxiter) + 1
    result = PTAFitResult(out)
    result.stats = {
        "npulsars": len(pairs), "ntoa_total": ntoa_total,
        "iterations": niter, "wall_time_s": wall,
        "device_solve_s": solve_s, "build_problem_s": build_s,
        "toas_per_sec": ntoa_total * niter / wall if wall else 0.0}
    fit_pta.last_stats = result.stats
    return result
