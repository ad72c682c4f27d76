"""Matrix-free GLS: streaming normal-equation accumulation and a
preconditioned conjugate-gradient solve (a port of
pint_tpu/parallel/streaming.py). The step's precision routes reach it
through ``build_fit_parts``: a float32 chunk design (``jac_f32``) keeps
the chunk's wide elementwise work in float32, ``matmul_f32`` takes the
chunk Gram in float32, and the finalize unscales the float32 Jacobian's
parameters (``meta["sfull"]``).

The noise covariance is diagonal (plus ECORR's rank-1 block per
observing epoch) plus a rank-q basis term, so the whitened normal
equations

    Sigma = [M|F]^T N_eff^-1 [M|F] + diag(0, 1/phi),
    b     = [M|F]^T N_eff^-1 r

are accumulated chunk by chunk over the TOAs and never need the
(N, p+q) design at full N: peak device memory is O(chunk + (p+q)^2).

- The chunk accumulator (``_acc_chunk``) evaluates ``build_fit_parts``'s
  assembly (phase, jacfwd design, bases; the dense step's own code) on
  one fixed-length chunk of TOAs uploaded from the host, and folds its
  Gram, cross and moment terms into a small state that stays on the
  device. ECORR rides the Sherman-Morrison segment path with a boundary
  carry: in the epoch-sorted stream a chunk boundary splits at most one
  epoch, whose partial sums carry to the next chunk. The weighted-mean
  subtraction of the residuals is applied afterwards from accumulated
  scalars (``_finalize_prep``), since a chunk cannot know the mean.
- The finalize (``_cg_schur``) solves the parameter block through the
  Schur complement of the basis block, S = A - B^T C^-1 B, applied
  without forming it (C^-1 is one q x q Cholesky), by Jacobi-
  preconditioned CG over the stacked right-hand sides [b_schur | I_p]:
  the solution and S^-1 (the covariance) in one loop.

Column scales of the M block are kept relative to a running column max
(``cm``), rescaled when a chunk raises it, as the dense step's two-stage
column scaling does.

Segment sums within a chunk use a gather table made on the host (the
step's ``SegmentSum``), not float atomics, so a pass repeats bit for bit.
CG converged columns are frozen by ``torch.where``: iterations after
convergence leave the state unchanged, so the stop test is read only
every ``CG_CHECK_EVERY`` iterations. The numpy mirrors (``acc_update_np``,
``cg_solve_np``, ``stream_solve_np``) are copies of the reference's, the
host oracle of the same algebra.

Health ($PINT_TPU_HEALTH, ``obs.health``): armed, each chunk also
returns [nonfinite count, worst colmax growth] and one observation a
pass records the worst of them (``stream.chunk``); the finalize's CG
effort (iterations against the budget, final relative residual) is
observed at each solve (``stream.solve``). With $PINT_TPU_SHADOW_RATE
the solve's shadow replays the SAME accumulated state through the numpy
CG mirror in a background thread and records the drift in sigma.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from pint_tpu_torch import resolve_device
from pint_tpu_torch.config import stream_chunk
from pint_tpu_torch.gls import _symm_mm, cho_factor, cho_solve, jacobi
from pint_tpu_torch.parallel.fit_step import SegmentSum, _tree_map, \
    build_fit_parts

__all__ = ["StreamingGLS", "stream_solve_np", "acc_init_np",
           "acc_update_np", "acc_finalize_np", "cg_solve_np"]

CG_CHECK_EVERY = 8  # CG iterations between two reads of the stop test


# ------------------------------------------------------------ algebra
#
# Accumulator state (P = p + q), device tensors:
#   cm    (p,)    running column max of |M|
#   Sig   (P,P)   [M/cm | F]^T W [M/cm | F], ECORR-downdated for every
#                 complete epoch seen so far
#   b     (P,)    [M/cm | F]^T W r0, same downdates
#   u     (P,)    [M/cm | F]^T w*tmask      (mean-correction vector)
#   vE    (P,)    sum_k g_k s_k E_k         (mean x ECORR cross term)
#   scal  (8,)    [rCr0, swr0, sw, e_rr, e_swr, e_ss, carry_s, carry_wr]
#   carE  (P,)    partial E row of the boundary epoch
#   cjv   ()      boundary epoch's jitter variance
#   cid   ()      boundary epoch's global id (int64; -1 = none)


def _init_state(p: int, q: int, device):
    f = dict(dtype=torch.float64, device=device)
    P = p + q
    return (torch.ones(p, **f), torch.zeros((P, P), **f), torch.zeros(P, **f),
            torch.zeros(P, **f), torch.zeros(P, **f), torch.zeros(8, **f),
            torch.zeros(P, **f), torch.zeros((), **f),
            torch.full((), -1, dtype=torch.long, device=device))


def _rescale_state(cm, Sig, b, u, vE, carE, cm_new, p):
    """Re-express every M-block quantity relative to a grown column max
    (a pure rescaling)."""
    rho = cm / cm_new
    rfull = torch.cat([rho, rho.new_ones(Sig.shape[0] - p)])
    Sig = Sig * torch.outer(rfull, rfull)
    return Sig, b * rfull, u * rfull, vE * rfull, carE * rfull


def _add_at(x, i, v):
    """x with v added to element i (a copy)."""
    x = x.clone()
    x[i] = x[i] + v
    return x


def _acc_chunk(state, M, Fv, r0, nvec, valid, tmask, seg=None, jvar=None,
               seg_eid=None, health=False, f32mm=False):
    """Fold one chunk into the accumulator state. ``seg`` (a
    ``SegmentSum`` over the chunk's epochs, in order), ``jvar`` (the
    per-epoch jitter variances) and ``seg_eid`` (each segment's global
    epoch id) switch the ECORR downdates on; the chunk's rows must be
    epoch-sorted.

    With ``health`` the chunk returns ``(state, hv)``, hv the 2-vector
    [nonfinite count across the accumulated (Sig, b) and the chunk's
    design and residual rows, the worst running-colmax growth this
    chunk caused] (a huge late rescale is the scale-safety machinery
    working overtime). Without it, the ops of the health-free chunk.

    A float32 ``M`` keeps the chunk's (C, p+q)-wide work in float32;
    ``f32mm`` takes the Gram products in float32 (``gls._symm_mm``).
    The state stays float64."""
    cm, Sig, b, u, vE, scal, carE, cjv, cid = state
    p = cm.shape[0]
    mdt = M.dtype
    w = valid / nvec
    # running column max: grow only, then rescale the history
    cm_c = torch.amax(torch.abs(M) * valid[:, None].to(mdt),
                      dim=0).to(torch.float64)
    cm_new = torch.maximum(cm, torch.where(cm_c == 0, cm, cm_c))
    cm_new = torch.where(cm_new == 0, torch.ones_like(cm_new), cm_new)
    if health:
        # cm is grow-only and >= 1 after init: the ratio is defined
        resc = torch.amax(cm_new / torch.where(cm == 0,
                                               torch.ones_like(cm), cm))
    Sig, b, u, vE, carE = _rescale_state(cm, Sig, b, u, vE, carE, cm_new, p)
    cm = cm_new

    def _out(st):
        if not health:
            return st

        def nf(x):
            return torch.sum(~torch.isfinite(x)).to(torch.float64)

        return st, torch.stack([nf(st[1]) + nf(st[2]) + nf(M) + nf(r0),
                                resc])
    big = torch.cat([M / cm[None, :].to(mdt), Fv.to(mdt)], dim=1)
    bigs = big * torch.sqrt(w)[:, None].to(mdt)
    Sig = Sig + _symm_mm(bigs, bigs, f32mm)
    bigw = big.to(torch.float64) * w[:, None]
    b = b + bigw.T @ r0
    u = u + bigw.T @ tmask
    wt = w * tmask
    scal = torch.cat([scal[:3] + torch.stack([torch.sum(w * r0 * r0),
                                              torch.sum(wt * r0),
                                              torch.sum(wt)]), scal[3:]])
    if seg is None:
        return _out((cm, Sig, b, u, vE, scal, carE, cjv, cid))

    # ---- ECORR Sherman-Morrison with the boundary carry ---------------
    s_seg = seg(w)
    E_seg = seg(bigw)
    wr_seg = seg(w * r0)
    jv_seg = jvar[seg_eid]
    # merge the carried epoch into segment 0 when it is the same global
    # epoch; otherwise the carry is complete: downdate it
    merge = (seg_eid[0] == cid) & (cid >= 0)
    c_s, c_wr = scal[6], scal[7]
    g_c = torch.where(merge, 0.0, cjv / (1.0 + cjv * c_s))
    Sig = Sig - g_c * torch.outer(carE, carE)
    b = b - g_c * c_wr * carE
    vE = vE + g_c * c_s * carE
    scal = _add_at(scal, 3, g_c * c_wr * c_wr)
    scal = _add_at(scal, 4, g_c * c_s * c_wr)
    scal = _add_at(scal, 5, g_c * c_s * c_s)
    s_seg = _add_at(s_seg, 0, torch.where(merge, c_s, 0.0))
    wr_seg = _add_at(wr_seg, 0, torch.where(merge, c_wr, 0.0))
    E_seg = _add_at(E_seg, 0, torch.where(merge, 1.0, 0.0) * carE)
    jv_seg = jv_seg.clone()
    jv_seg[0] = torch.maximum(jv_seg[0], torch.where(merge, cjv, 0.0))
    # complete segments: all but the chunk's last epoch, which carries
    L = s_seg.shape[0] - 1
    mask = (torch.arange(L + 1, device=w.device) < L).to(w.dtype)
    g = jv_seg / (1.0 + jv_seg * s_seg) * mask
    sg = torch.sqrt(g)
    Eg = E_seg * sg[:, None]
    Sig = Sig - _symm_mm(Eg.to(mdt), Eg.to(mdt), f32mm)
    b = b - Eg.T @ (sg * wr_seg)
    vE = vE + Eg.T @ (sg * s_seg)
    scal = _add_at(scal, 3, torch.sum(g * wr_seg * wr_seg))
    scal = _add_at(scal, 4, torch.sum(g * s_seg * wr_seg))
    scal = _add_at(scal, 5, torch.sum(g * s_seg * s_seg))
    scal = torch.cat([scal[:6], torch.stack([s_seg[L], wr_seg[L]])])
    return _out((cm, Sig, b, u, vE, scal, E_seg[L], jv_seg[L], seg_eid[L]))


def _flush_carry(state):
    """Downdate the last boundary epoch (end of stream)."""
    cm, Sig, b, u, vE, scal, carE, cjv, cid = state
    c_s, c_wr = scal[6], scal[7]
    g_c = torch.where(cid >= 0, cjv / (1.0 + cjv * c_s), 0.0)
    Sig = Sig - g_c * torch.outer(carE, carE)
    b = b - g_c * c_wr * carE
    vE = vE + g_c * c_s * carE
    scal = _add_at(scal, 3, g_c * c_wr * c_wr)
    scal = _add_at(scal, 4, g_c * c_s * c_wr)
    scal = _add_at(scal, 5, g_c * c_s * c_s)
    scal = torch.cat([scal[:6], scal.new_zeros(2)])
    return (cm, Sig, b, u, vE, scal, torch.zeros_like(carE),
            torch.zeros_like(cjv), torch.full_like(cid, -1))


def _finalize_prep(state, phi, incoffset: bool):
    """Mean-correct and prior-load the accumulated system: (Sigma, b,
    rCr, cm) of the dense normal equations the one-shot step would have
    assembled (up to rounding)."""
    cm, Sig, b, u, vE, scal, _, _, _ = state
    p = cm.shape[0]
    rCr0, swr0, sw = scal[0], scal[1], scal[2]
    e_rr, e_swr, e_ss = scal[3], scal[4], scal[5]
    pos = sw > 0
    mu = torch.where(pos, swr0 / torch.where(pos, sw, torch.ones_like(sw)),
                     0.0) if incoffset else torch.zeros_like(sw)
    # the mean correction r -> r0 - mu: b loses mu*(u - vE) (vE is the
    # ECORR downdate's response to the constant direction)
    b = b - mu * (u - vE)
    rCr = (rCr0 - 2.0 * mu * swr0 + mu * mu * sw) \
        - (e_rr - 2.0 * mu * e_swr + mu * mu * e_ss)
    q = Sig.shape[0] - p
    prior = torch.cat([cm.new_zeros(p), 1.0 / phi]) if q else cm.new_zeros(p)
    return Sig + torch.diag(prior), b, rCr, cm


def _cg_schur(Sigma, b, rCr, cm, budget: int, tol: float):
    """Matrix-free preconditioned CG of the parameter block of
    ``Sigma x = b`` through the Schur complement of the basis block.
    Returns (dparams, cov, chi2, chi2r, xf, ok, iters, rel_resid):
    dparams the correction to add, chi2 the linearized post-fit chi2,
    chi2r the basis-marginalized chi2 at the point, xf the basis
    amplitudes, ok False when the basis Cholesky or CG failed, iters the
    CG iterations (at most ``budget``), rel_resid the worst final
    relative residual of the stacked right-hand sides. The tensors stay
    on the device; ``iters`` is an int."""
    P = Sigma.shape[0]
    p = cm.shape[0]
    q = P - p
    d = jacobi(Sigma)
    St = Sigma / torch.outer(d, d)
    bt = b / d
    A = St[:p, :p]
    if q:
        B = St[p:, :p]
        L = cho_factor(St[p:, p:])
        CiB = cho_solve(L, B)
        bF = bt[p:]
        CibF = cho_solve(L, bF)
        rhs0 = bt[:p] - B.T @ CibF
        chi2r = rCr - bF @ CibF
        # the exact Schur diagonal: the preconditioner of the reduced
        # system (diag(A) is 1 after scaling)
        dS = 1.0 - torch.sum(B * CiB, dim=0)
    else:
        rhs0 = bt[:p]
        chi2r = rCr
        dS = torch.ones_like(rhs0)
    dS = torch.where(dS > 1e-14, dS, torch.ones_like(dS))

    def op(V):
        out = A @ V
        if q:
            out = out - CiB.T @ (B @ V)
        return out

    RHS = torch.cat([rhs0[:, None], torch.eye(p, dtype=St.dtype,
                                               device=St.device)], dim=1)
    bnorm = torch.sqrt(torch.sum(RHS * RHS, dim=0))
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    X = torch.zeros_like(RHS)
    R = RHS
    Pd = R / dS[:, None]
    rz = torch.sum(R * Pd, dim=0)
    nact = torch.zeros(p + 1, dtype=torch.long, device=St.device)

    def active(R):
        return torch.sqrt(torch.sum(R * R, dim=0)) > tol * bnorm

    k = 0
    while k < budget:
        for _ in range(min(CG_CHECK_EVERY, budget - k)):
            act = active(R)
            AP = op(Pd)
            pAp = torch.sum(Pd * AP, dim=0)
            alpha = torch.where(act & (pAp > 0),
                                rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
            Xn = X + alpha[None, :] * Pd
            Rn = R - alpha[None, :] * AP
            Zn = Rn / dS[:, None]
            rzn = torch.sum(Rn * Zn, dim=0)
            beta = torch.where(act & (rz > 0),
                               rzn / torch.where(rz > 0, rz, 1.0), 0.0)
            Pn = Zn + beta[None, :] * Pd
            # converged columns stay as they are
            X = torch.where(act[None, :], Xn, X)
            R = torch.where(act[None, :], Rn, R)
            Pd = torch.where(act[None, :], Pn, Pd)
            rz = torch.where(act, rzn, rz)
            nact = nact + act
            k += 1
        if not bool(torch.any(active(R))):
            break
    xt = X[:, 0]
    Sinv = X[:, 1:]
    if q:
        yt = cho_solve(L, bF - B @ xt)
        chi2 = rCr - (xt @ bt[:p] + yt @ bF)
        xf = yt / d[p:]
    else:
        chi2 = rCr - xt @ bt[:p]
        xf = xt.new_zeros(0)
    scale = d[:p] * cm
    dparams = -xt / scale
    cov = Sinv / torch.outer(scale, scale)
    resid = torch.max(torch.sqrt(torch.sum(R * R, dim=0)) / bnorm)
    ok = torch.all(torch.isfinite(xt)) & torch.all(torch.isfinite(cov)) \
        & torch.isfinite(chi2) & (resid <= tol ** 0.5)
    return dparams, cov, chi2, chi2r, xf, ok, int(torch.max(nact)), resid


def _cg_schur_batch(Sigma, b, rCr, cm, budget: int, tol: float):
    """``_cg_schur`` over a leading slot axis: Sigma (P, n, n), b (P, n),
    rCr (P,), cm (P, p). Every slot runs the algebra of ``_cg_schur``
    (its columns freeze as they converge, as they do there); the loop
    ends when no column of any slot is active or at ``budget``. Returns
    the same tuple with a leading P axis; ``iters`` is the (P,) long
    tensor of each slot's CG iterations (at most ``budget``), ``ok`` and
    ``rel_resid`` per slot. The serve append path's program (the
    streaming fitter keeps ``_cg_schur``)."""
    n = Sigma.shape[-1]
    p = cm.shape[-1]
    q = n - p
    d = jacobi(Sigma)
    St = Sigma / (d[..., :, None] * d[..., None, :])
    bt = b / d
    A = St[..., :p, :p]
    if q:
        B = St[..., p:, :p]
        L = cho_factor(St[..., p:, p:])
        CiB = cho_solve(L, B)
        bF = bt[..., p:]
        CibF = cho_solve(L, bF)
        rhs0 = bt[..., :p] - (B.mT @ CibF[..., None])[..., 0]
        chi2r = rCr - torch.sum(bF * CibF, dim=-1)
        dS = 1.0 - torch.sum(B * CiB, dim=-2)
    else:
        rhs0 = bt[..., :p]
        chi2r = rCr
        dS = torch.ones_like(rhs0)
    dS = torch.where(dS > 1e-14, dS, torch.ones_like(dS))

    def op(V):
        out = A @ V
        if q:
            out = out - CiB.mT @ (B @ V)
        return out

    eye = torch.eye(p, dtype=St.dtype, device=St.device).expand(
        rhs0.shape[:-1] + (p, p))
    RHS = torch.cat([rhs0[..., None], eye], dim=-1)
    bnorm = torch.sqrt(torch.sum(RHS * RHS, dim=-2))
    bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    X = torch.zeros_like(RHS)
    R = RHS
    Pd = R / dS[..., :, None]
    rz = torch.sum(R * Pd, dim=-2)
    nact = torch.zeros(rz.shape, dtype=torch.long, device=St.device)

    def active(R):
        return torch.sqrt(torch.sum(R * R, dim=-2)) > tol * bnorm

    k = 0
    while k < budget:
        for _ in range(min(CG_CHECK_EVERY, budget - k)):
            act = active(R)
            AP = op(Pd)
            pAp = torch.sum(Pd * AP, dim=-2)
            alpha = torch.where(act & (pAp > 0),
                                rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
            Xn = X + alpha[..., None, :] * Pd
            Rn = R - alpha[..., None, :] * AP
            Zn = Rn / dS[..., :, None]
            rzn = torch.sum(Rn * Zn, dim=-2)
            beta = torch.where(act & (rz > 0),
                               rzn / torch.where(rz > 0, rz, 1.0), 0.0)
            Pn = Zn + beta[..., None, :] * Pd
            # converged columns (of every slot) stay as they are
            X = torch.where(act[..., None, :], Xn, X)
            R = torch.where(act[..., None, :], Rn, R)
            Pd = torch.where(act[..., None, :], Pn, Pd)
            rz = torch.where(act, rzn, rz)
            nact = nact + act
            k += 1
        if not bool(torch.any(active(R))):
            break
    xt = X[..., 0]
    Sinv = X[..., 1:]
    if q:
        yt = cho_solve(L, bF - (B @ xt[..., None])[..., 0])
        chi2 = rCr - (torch.sum(xt * bt[..., :p], dim=-1)
                      + torch.sum(yt * bF, dim=-1))
        xf = yt / d[..., p:]
    else:
        chi2 = rCr - torch.sum(xt * bt[..., :p], dim=-1)
        xf = xt.new_zeros(xt.shape[:-1] + (0,))
    scale = d[..., :p] * cm
    dparams = -xt / scale
    cov = Sinv / (scale[..., :, None] * scale[..., None, :])
    resid = torch.amax(torch.sqrt(torch.sum(R * R, dim=-2)) / bnorm,
                       dim=-1)
    ok = torch.all(torch.isfinite(xt), dim=-1) \
        & torch.all(torch.isfinite(cov).flatten(-2), dim=-1) \
        & torch.isfinite(chi2) & (resid <= tol ** 0.5)
    return dparams, cov, chi2, chi2r, xf, ok, torch.amax(nact, dim=-1), \
        resid


def _finalize_kernel(state, phi, budget: int, tol: float,
                     incoffset: bool = True, sfull=None):
    """Flush the ECORR carry, mean-correct, and CG-solve. ``sfull`` (the
    float32 Jacobian's column scales, None without it) maps dparams and
    cov back from the scaled parameters."""
    Sigma, b, rCr, cm = _finalize_prep(_flush_carry(state), phi, incoffset)
    out = _cg_schur(Sigma, b, rCr, cm, budget, tol)
    if sfull is None:
        return out
    return (out[0] * sfull, out[1] * torch.outer(sfull, sfull)) + out[2:]


# ------------------------------------------------------ numpy mirror


def acc_init_np(p: int, q: int):
    """Zero accumulator state (host mirror layout == device layout)."""
    P = p + q
    return [np.ones(p), np.zeros((P, P)), np.zeros(P), np.zeros(P),
            np.zeros(P), np.zeros(8), np.zeros(P), np.asarray(0.0),
            np.asarray(-1, np.int32)]


def acc_update_np(state, M, F, r0, nvec, valid, tmask=None,
                  eid=None, jv_toa=None):
    """Numpy mirror of ``_acc_chunk`` (f64 accumulation, same
    boundary-carry ECORR downdates). Mutates and returns ``state``."""
    cm, Sig, b, u, vE, scal, carE, cjv, cid = state
    p = cm.shape[0]
    M = np.asarray(M, np.float64)
    C = M.shape[0]
    if tmask is None:
        tmask = valid
    w = valid / nvec
    cm_c = np.max(np.abs(M) * valid[:, None], axis=0) \
        if C else np.zeros(p)
    cm_new = np.maximum(cm, np.where(cm_c == 0, cm, cm_c))
    cm_new[cm_new == 0] = 1.0
    rho = cm / cm_new
    rfull = np.concatenate([rho, np.ones(Sig.shape[0] - p)])
    Sig *= np.outer(rfull, rfull)
    b *= rfull
    u *= rfull
    vE *= rfull
    carE *= rfull
    cm = cm_new
    big = np.concatenate([M / cm[None, :], np.asarray(F, np.float64)],
                         axis=1)
    bigw = big * w[:, None]
    Sig += big.T @ bigw
    b += bigw.T @ r0
    u += bigw.T @ tmask
    wt = w * tmask
    scal[0] += float(np.sum(w * r0 * r0))
    scal[1] += float(np.sum(wt * r0))
    scal[2] += float(np.sum(wt))
    state[0], state[1], state[2], state[3], state[4] = \
        cm, Sig, b, u, vE
    if eid is None or jv_toa is None:
        return state
    # ECORR boundary carry (mirror of the in-kernel path)
    eid = np.asarray(eid)
    if not np.all(np.diff(eid) >= 0):
        raise ValueError("streaming ECORR requires epoch-sorted rows")
    uniq, starts = np.unique(eid, return_index=True)
    ends = np.append(starts[1:], C)
    for k0, (gidx, s0, s1) in enumerate(zip(uniq, starts, ends)):
        seg_w = w[s0:s1]
        s_s = float(np.sum(seg_w))
        E_s = bigw[s0:s1].T @ np.ones(s1 - s0)
        wr_s = float(np.sum(seg_w * r0[s0:s1]))
        jv_s = float(np.max(jv_toa[s0:s1])) if s1 > s0 else 0.0
        if k0 == 0 and gidx == int(cid) and int(cid) >= 0:
            s_s += scal[6]
            wr_s += scal[7]
            E_s = E_s + carE
            jv_s = max(jv_s, float(cjv))
        elif k0 == 0 and int(cid) >= 0:
            _downdate_np(state, float(cjv))
            cid = np.asarray(-1, np.int32)
        if gidx == uniq[-1]:
            scal[6], scal[7] = s_s, wr_s
            state[6] = E_s
            state[7] = np.asarray(jv_s)
            state[8] = np.asarray(gidx, np.int32)
        else:
            g = jv_s / (1.0 + jv_s * s_s)
            state[1] -= g * np.outer(E_s, E_s)
            state[2] -= g * wr_s * E_s
            state[4] += g * s_s * E_s
            scal[3] += g * wr_s * wr_s
            scal[4] += g * s_s * wr_s
            scal[5] += g * s_s * s_s
    return state


def _downdate_np(state, jv):
    """Downdate the carried boundary epoch in the host mirror."""
    scal = state[5]
    c_s, c_wr = scal[6], scal[7]
    carE = state[6]
    g = jv / (1.0 + jv * c_s)
    state[1] -= g * np.outer(carE, carE)
    state[2] -= g * c_wr * carE
    state[4] += g * c_s * carE
    scal[3] += g * c_wr * c_wr
    scal[4] += g * c_s * c_wr
    scal[5] += g * c_s * c_s
    scal[6] = 0.0
    scal[7] = 0.0
    state[6] = np.zeros_like(carE)
    state[7] = np.asarray(0.0)
    state[8] = np.asarray(-1, np.int32)


def cg_solve_np(Sigma, b, rCr, cm, budget=None, tol=1e-13):
    """Numpy mirror of ``_cg_schur`` (same Jacobi scaling, Schur
    operator, preconditioned CG over stacked right-hand sides)."""
    from scipy.linalg import cho_factor as sp_cho_factor
    from scipy.linalg import cho_solve as sp_cho_solve

    P = Sigma.shape[0]
    p = cm.shape[0]
    q = P - p
    d = np.sqrt(np.diagonal(Sigma)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    St = Sigma / np.outer(d, d)
    bt = b / d
    A = St[:p, :p]
    if q:
        B = St[p:, :p]
        cf = sp_cho_factor(St[p:, p:], lower=True)
        CiB = sp_cho_solve(cf, B)
        bF = bt[p:]
        CibF = sp_cho_solve(cf, bF)
        rhs0 = bt[:p] - B.T @ CibF
        chi2r = rCr - bF @ CibF
        dS = 1.0 - np.sum(B * CiB, axis=0)
    else:
        B = np.zeros((0, p))
        CiB = np.zeros((0, p))
        rhs0 = bt[:p]
        chi2r = rCr
        dS = np.ones(p)
    dS = np.where(dS > 1e-14, dS, 1.0)
    if budget is None:
        budget = 8 * (p + 1)

    def op(V):
        out = A @ V
        if q:
            out = out - CiB.T @ (B @ V)
        return out

    RHS = np.concatenate([rhs0[:, None], np.eye(p)], axis=1)
    bnorm = np.sqrt(np.sum(RHS * RHS, axis=0))
    bnorm[bnorm == 0] = 1.0
    X = np.zeros_like(RHS)
    R = RHS.copy()
    Z = R / dS[:, None]
    rz = np.sum(R * Z, axis=0)
    Pd = Z.copy()
    iters = 0
    for _ in range(int(budget)):
        act = np.sqrt(np.sum(R * R, axis=0)) > tol * bnorm
        if not np.any(act):
            break
        iters += 1
        AP = op(Pd)
        pAp = np.sum(Pd * AP, axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = np.where(act & (pAp > 0), rz / np.where(
                pAp > 0, pAp, 1.0), 0.0)
        X += alpha[None, :] * Pd
        R -= alpha[None, :] * AP
        Zn = R / dS[:, None]
        rzn = np.sum(R * Zn, axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.where(act & (rz > 0), rzn / np.where(
                rz > 0, rz, 1.0), 0.0)
        Pd = Zn + beta[None, :] * Pd
        rz = rzn
    xt = X[:, 0]
    Sinv = X[:, 1:]
    if q:
        yt = sp_cho_solve(cf, bF - B @ xt)
        chi2 = rCr - (xt @ bt[:p] + yt @ bF)
        xf = yt / d[p:]
    else:
        chi2 = rCr - xt @ bt[:p]
        xf = np.zeros(0)
    scale = d[:p] * cm
    dparams = -xt / scale
    cov = Sinv / np.outer(scale, scale)
    resid = float(np.max(np.sqrt(np.sum(R * R, axis=0)) / bnorm))
    ok = bool(np.all(np.isfinite(xt)) and np.all(np.isfinite(cov))
              and np.isfinite(chi2) and resid <= np.sqrt(tol))
    return (dparams, cov, float(chi2), float(chi2r), xf, ok, iters,
            resid)


def acc_finalize_np(state, phi, incoffset=True, budget=None, tol=1e-13,
                    sfull=None):
    """Numpy mirror of ``_finalize_kernel``: flush carry,
    mean-correct, prior-load, CG-solve (and unscale by ``sfull``)."""
    if int(state[8]) >= 0:
        _downdate_np(state, float(state[7]))
    cm, Sig, b, u, vE, scal = state[0], state[1], state[2], \
        state[3], state[4], state[5]
    p = cm.shape[0]
    rCr0, swr0, sw = scal[0], scal[1], scal[2]
    e_rr, e_swr, e_ss = scal[3], scal[4], scal[5]
    mu = (swr0 / sw) if (incoffset and sw > 0) else 0.0
    b = b - mu * (u - vE)
    rCr = (rCr0 - 2.0 * mu * swr0 + mu * mu * sw) \
        - (e_rr - 2.0 * mu * e_swr + mu * mu * e_ss)
    q = Sig.shape[0] - p
    prior = np.concatenate([np.zeros(p), 1.0 / np.asarray(phi)]) \
        if q else np.zeros(p)
    Sigma = Sig + np.diag(prior)
    out = cg_solve_np(Sigma, b, float(rCr), cm, budget=budget, tol=tol)
    if sfull is None:
        return out
    sfull = np.asarray(sfull, np.float64)
    return (out[0] * sfull, out[1] * np.outer(sfull, sfull)) + \
        tuple(out[2:])


def stream_solve_np(M, F, phi, r0, nvec, chunk: int,
                    incoffset: bool = True, eid=None, jvar=None,
                    tol=1e-13):
    """Host streaming solve over prebuilt dense rows (the oracle path):
    chunked ``acc_update_np`` + ``acc_finalize_np``. ``r0`` must be the
    residuals without the mean subtracted."""
    M = np.asarray(M, np.float64)
    n, p = M.shape
    F = np.asarray(F, np.float64)
    q = F.shape[1]
    state = acc_init_np(p, q)
    jv_toa = None if (eid is None or jvar is None) \
        else np.asarray(jvar)[np.asarray(eid)]
    for s0 in range(0, n, int(chunk)):
        s1 = min(n, s0 + int(chunk))
        sl = slice(s0, s1)
        acc_update_np(
            state, M[sl], F[sl], np.asarray(r0)[sl],
            np.asarray(nvec)[sl], np.ones(s1 - s0),
            eid=None if eid is None else np.asarray(eid)[sl],
            jv_toa=None if jv_toa is None else jv_toa[sl])
    return acc_finalize_np(state, phi, incoffset=incoffset, tol=tol)


# --------------------------------------------------------- StreamingGLS


class StreamingGLS:
    """One model and TOA set's streaming GLS: the chunked accumulator and
    the CG finalize, re-runnable at any parameter point (th, tl); the
    unit ``StreamingGLSFitter`` iterates (reference: StreamingGLS).

    At build, ``build_fit_parts`` (the dense step's assembly) is made
    with its TOA-axis arguments on the host, rows are sorted by epoch
    when ECORR is on (accumulation does not depend on row order, and
    epoch-contiguous rows let a chunk boundary split at most one epoch),
    and each chunk's segment table is made. A pass (``accumulate``)
    uploads one chunk at a time to ``device`` (the model's by default);
    the last chunk is padded by repeating its last row with valid = 0
    (the reference's ``_pad_leaf`` convention). ``flags`` go to
    ``build_fit_parts`` (``hybrid_jac`` and the precision routes
    ``anchored``, ``jac_f32``, ``matmul_f32``); wideband TOAs are refused.
    ``health`` (None: $PINT_TPU_HEALTH) arms the chunk and solve taps
    (module docstring)."""

    def __init__(self, model, toas, chunk: Optional[int] = None,
                 device=None, health=None, **flags):
        from pint_tpu_torch import config

        if flags.pop("wideband", False):
            raise ValueError("streaming GLS does not support wideband TOAs "
                             "(stacked DM rows); use the dense fitters")
        self.health_on = config.health_enabled(health)
        self.last_pass_hv = None   # worst chunk vector of the last pass
        dev = model.device if device is None else resolve_device(device)
        self.device = dev
        parts_fn, args, names, meta = build_fit_parts(
            model, toas, device=dev, arg_device="cpu", **flags)
        self.parts_fn = parts_fn
        self.names = names
        self.meta = meta
        self.model = model
        self.toas = toas
        n = toas.ntoas
        self.ntoa = n
        self.chunk = stream_chunk(n) if chunk is None else int(chunk)
        (th, tl, fh, fl, batch, sc, F, phi, nvec, valid, eid,
         jvar) = args
        self.th0 = th.numpy().copy()
        self.tl0 = tl.numpy().copy()
        self.phi = phi.numpy()
        self._fh, self._fl, self._phi, self._jvar = (
            x.to(dev) for x in (fh, fl, phi, jvar))
        self.p = len(names)
        self.q = self.phi.shape[0]
        self.incoffset = bool(meta["incoffset"])
        self.f32mm = bool(meta["f32mm"])
        # the float32 Jacobian's unscale vector (None without it)
        self.sfull = np.asarray(meta["sfull"], np.float64) \
            if meta["jac32"] else None
        self._sfull = None if self.sfull is None else \
            torch.as_tensor(self.sfull, device=dev)
        eid_np = eid.numpy()
        # epoch-sort permutation for the boundary-carry ECORR path
        perm = None
        if meta["has_ecorr"] and np.any(np.diff(eid_np) < 0):
            perm = np.argsort(eid_np, kind="stable")
        self._perm = perm

        def host(a):
            a = a.numpy()
            if perm is not None and a.ndim == 3 and a.shape[1] == n:
                return a[:, perm]
            if perm is not None and a.ndim >= 1 and a.shape[0] == n:
                return a[perm]
            return a

        # the TZR TOA's entries are not per-TOA: on the device once
        fixed = ("tzr", "tzr_batch")
        self._batch = _tree_map(host, batch)
        self._sc = _tree_map(host, {k: v for k, v in sc.items()
                                    if k not in fixed})
        self._sc_fixed = _tree_map(lambda x: x.to(dev),
                                   {k: v for k, v in sc.items()
                                    if k in fixed})
        self._F = host(F)
        self._nvec = host(nvec)
        self._valid = host(valid)
        self._eid = host(eid)
        self.nchunks = -(-n // self.chunk)
        # per-chunk segment tables of the epoch ids, made on the host
        self._plans = None
        if meta["has_ecorr"]:
            self._plans = []
            for k in range(self.nchunks):
                uniq, rid = np.unique(self._cut(self._eid, k),
                                      return_inverse=True)
                self._plans.append(
                    (SegmentSum(torch.as_tensor(rid), len(uniq)),
                     torch.as_tensor(uniq, dtype=torch.long)))

    # -- chunk views ---------------------------------------------------

    def _cut(self, a, k: int):
        """Chunk k of a TOA-axis array (other arrays as they are), the
        last chunk edge-padded."""
        C, n = self.chunk, self.ntoa
        s0, s1 = k * C, min(n, (k + 1) * C)
        pad = C - (s1 - s0)
        if a.ndim == 3 and a.shape[1] == n:
            v = a[:, s0:s1]
            return np.pad(v, [(0, 0), (0, pad), (0, 0)],
                          mode="edge") if pad else v
        if a.ndim >= 1 and a.shape[0] == n:
            v = a[s0:s1]
            return np.pad(v, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                          mode="edge") if pad else v
        return a

    def _chunk(self, k: int):
        """Chunk k's arguments of ``parts_fn`` and its segment plan, on
        the device."""
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                self._cut(a, k))).to(dev)

        batch_c = _tree_map(up, self._batch)
        sc_c = {**_tree_map(up, self._sc), **self._sc_fixed}
        valid = self._cut(self._valid, k)
        pad = self.chunk - min(self.chunk, self.ntoa - k * self.chunk)
        if pad:
            valid = valid.copy()
            valid[-pad:] = 0.0
        valid_c = torch.from_numpy(valid).to(dev)
        plan = None
        if self._plans is not None:
            seg, seg_eid = self._plans[k]
            plan = (seg.to(dev), seg_eid.to(dev))
        return (batch_c, sc_c, up(self._F), up(self._nvec), valid_c,
                up(self._eid), plan)

    @property
    def default_budget(self) -> int:
        """CG iteration budget when ``solve`` is given none: exact
        arithmetic ends in <= p iterations; 8x is the rounding margin."""
        return 8 * (self.p + 1)

    # -- device passes -------------------------------------------------

    def accumulate(self, th, tl, observe: bool = True):
        """One streaming pass at the parameter point (th, tl) (host
        float64 arrays in the step's slots): ceil(N/C) supervised chunk
        dispatches (``stream.chunk``). Returns the accumulator state:
        host tensors after a guarded dispatch (the state, ~(p+q)^2
        float64, goes to the host between chunks, as in the reference,
        so the watchdog covers each chunk's device work). A DispatchError
        propagates to the fitter's failover boundary.

        Armed, the pass's worst chunk health vector is kept as
        ``last_pass_hv`` and observed once (``stream.chunk``);
        ``observe=False`` skips the observation (the downhill fitter's
        line-search trials: a rejected overshoot is the damping
        working, not an incident; the fitter observes the passes it
        keeps)."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import get_supervisor

        sup = get_supervisor()
        dev = self.device
        health_on = self.health_on
        th = np.asarray(th, np.float64)
        tl = np.asarray(tl, np.float64)

        def run(state, k):
            if state is None:
                state = _init_state(self.p, self.q, dev)
            else:
                state = tuple(x.to(dev) for x in state)
            th_d = torch.as_tensor(th, device=dev)
            tl_d = torch.as_tensor(tl, device=dev)
            batch_c, sc_c, F_c, nvec_c, valid_c, eid_c, plan = \
                self._chunk(k)
            with record_function("stream.chunk"):
                M, Fv, r0, nvec2, valid2, _, tmask = self.parts_fn(
                    th_d, tl_d, self._fh, self._fl, batch_c, sc_c, F_c,
                    self._phi, nvec_c, valid_c, eid_c, self._jvar)
                kw = {"health": health_on}
                if self.f32mm:
                    kw["f32mm"] = True
                if plan is None:
                    return _acc_chunk(state, M, Fv, r0, nvec2, valid2,
                                      tmask, **kw)
                return _acc_chunk(state, M, Fv, r0, nvec2, valid2,
                                  tmask, plan[0], self._jvar, plan[1],
                                  **kw)

        state = None
        hv_worst = None
        self.last_pass_hv = None
        with obs.span("stream.accumulate", ntoa=self.ntoa,
                      chunk=self.chunk, nchunks=self.nchunks):
            for k in range(self.nchunks):
                out = sup.dispatch(run, state, k, key="stream.chunk",
                                   device=dev)
                if health_on:
                    # the pass's worst chunk vector (max over both
                    # slots): one observation a pass, not one a chunk
                    state, hv = out
                    hv = hv.cpu().numpy()
                    hv_worst = hv if hv_worst is None else \
                        np.maximum(hv_worst, hv)
                else:
                    state = out
        if hv_worst is not None:
            self.last_pass_hv = hv_worst
            if observe:
                from pint_tpu_torch.obs import health as _health

                _health.observe("stream.chunk",
                                {"nonfinite": hv_worst[0],
                                 "rescale": hv_worst[1]},
                                key="stream.chunk")
        return state

    def solve(self, state, budget: Optional[int] = None,
              tol: float = 1e-13, observe: bool = True):
        """CG-finalize an accumulated state (one supervised dispatch,
        ``stream.solve``): (dparams, cov, chi2, chi2r, xf, ok, iters,
        rel_resid) on the host, dparams the correction
        to add, aligned with ``self.names``; chi2 the linearized
        post-fit chi2, chi2r the basis-marginalized chi2 at the point
        (``Residuals.chi2``'s meaning), xf the ML basis amplitudes.

        Health ($PINT_TPU_HEALTH) observes the CG effort against its
        budget (``observe=False`` skips it); shadow sampling
        ($PINT_TPU_SHADOW_RATE) replays the SAME state through the numpy
        CG mirror in a background thread and records the drift in sigma
        (the state is host-resident and (p+q)^2 small: the cheapest
        shadow of the stack)."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.obs import health as _health
        from pint_tpu_torch.runtime import get_supervisor

        if budget is None:
            budget = self.default_budget
        dev = self.device

        def run():
            with record_function("stream.solve"):
                return _finalize_kernel(
                    tuple(x.to(dev) for x in state), self._phi,
                    int(budget), float(tol), self.incoffset, self._sfull)

        def shadow(out):
            # the numpy mirror of the SAME state (copied: the mirror's
            # carry flush mutates); drift = max |d dp| in sigma of the
            # card's covariance. A failed CG (ok False: the caller
            # raises or rejects the trial) is not shadow-applicable
            if not bool(out[5]):
                return None
            mirror = [x.cpu().numpy().copy() for x in state]
            mdp = acc_finalize_np(mirror, self.phi,
                                  incoffset=self.incoffset,
                                  budget=budget, tol=tol,
                                  sfull=self.sfull)[0]
            return _health.drift_sigma(out[0].cpu().numpy(),
                                       out[1].cpu().numpy(), mdp)

        with obs.span("stream.solve", p=self.p, q=self.q):
            dp, cov, chi2, chi2r, xf, ok, iters, resid = \
                get_supervisor().dispatch(run, key="stream.solve",
                                          device=dev, shadow=shadow,
                                          shadow_kind="stream")
        if observe:
            _health.observe("stream.solve",
                            {"cg_iters": int(iters),
                             "cg_budget": int(budget),
                             "cg_rel_residual": float(resid),
                             "ok": bool(ok), "chi2": float(chi2r),
                             "values": [dp.cpu().numpy(), float(chi2)]},
                            key="stream.solve")
        return (dp.cpu().numpy(), cov.cpu().numpy(), float(chi2),
                float(chi2r), xf.cpu().numpy(), bool(ok), iters,
                float(resid))

    def noise_realization(self, xf) -> np.ndarray:
        """ML correlated-noise realization F @ xf [s] in the TOAs' own
        order (the epoch sort undone)."""
        noise = self._F @ np.asarray(xf)
        if self._perm is not None:
            out = np.empty_like(noise)
            out[self._perm] = noise
            return out
        return noise

    # -- host mirror ---------------------------------------------------

    def solve_np(self, tol: float = 1e-13):
        """The whole pass on the host: the dense rows at the MODEL'S
        current parameter point, then the chunked numpy accumulate and
        CG finalize (the oracle of the device pass)."""
        from pint_tpu_torch.residuals import Residuals

        model, toas = self.model, self.toas
        res = Residuals(toas, model, subtract_mean=False, device="cpu")
        M, _, _ = model.designmatrix(toas, incoffset=True, device="cpu")
        nvec = model.scaled_toa_uncertainty(toas) ** 2
        seg = model.noise_model_ecorr_segments(toas)
        if seg is not None:
            eid, jvar, exclude = seg
        else:
            eid, jvar, exclude = None, None, ()
        F = model.noise_model_designmatrix(toas, exclude=exclude)
        phi = model.noise_model_basis_weight(toas, exclude=exclude)
        if F is None:
            F, phi = np.zeros((toas.ntoas, 0)), np.ones(0)
        M = M.numpy()
        r0 = res.time_resids.numpy()
        if eid is not None and np.any(np.diff(eid) < 0):
            perm = np.argsort(eid, kind="stable")
            M, F, r0, nvec, eid = (M[perm], F[perm], r0[perm],
                                   nvec[perm], eid[perm])
        return stream_solve_np(M, F, phi, r0, nvec, self.chunk,
                               incoffset=self.incoffset, eid=eid,
                               jvar=jvar, tol=tol)
