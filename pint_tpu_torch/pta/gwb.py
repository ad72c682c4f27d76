"""Hellings–Downs cross-correlated GWB likelihood (a port of
pint_tpu/pta/gwb.py).

Reference: enterprise ``signal_base.LogLikelihood`` (basis-Woodbury
marginal likelihood) and van Haasteren & Vallisneri 2014 (1407.1838,
the low-rank GP formulation).

Model: the array covariance is

    C = blockdiag(D_a) + U (Gamma ⊗ diag(phi_g)) U^T

where ``D_a = N_a + T_a P_a T_a^T`` is pulsar *a*'s own marginal
covariance (white noise + improper-flat timing model + its per-pulsar
noise bases — EXACTLY the system ``parallel.pta._assemble_normal``
builds), ``U = blockdiag(U_a)`` stacks a COMMON-span Fourier basis,
``phi_g`` is the common-process power-law PSD (``models.noise.powerlaw``)
and ``Gamma`` the (Npsr, Npsr) HD overlap-reduction matrix.

Blocked Woodbury, two stages, both float64 torch on one device (with a
device mesh, the inner stage per block of pulsars on each device):

- inner (every pulsar of the batch at once): from the same preconditioned
  joint-normal Cholesky the batch solve runs, ``A_a = U_a^T D_a^{-1}
  U_a``, ``x_a = U_a^T D_a^{-1} r_a``, ``rdr_a = r_a^T D_a^{-1} r_a`` and
  ``ld_a = logdet D_a`` (up to the improper-prior constant);
- outer: the (Npsr*m)^2 cross-correlated system ``S = Gamma^{-1} ⊗
  diag(1/phi_g) + blockdiag(A_a)``, giving

    log L = -1/2 [ sum_a rdr_a - x^T S^{-1} x + sum_a ld_a
                   + m logdet Gamma + Npsr sum_i log phi_g_i
                   + logdet S ]  (+ const).

The GWB hyperparameters (log10_A, gamma) enter ONLY through the outer
stage, so the blocks are assembled once and a whole detection sweep
reuses them; a sweep chunk of K grid points is factored as one (K, Pm,
Pm) batch. The numpy mirror (``gwb_loglik_np``) is the CPU oracle and
the explicit ``pool="host"`` route.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.gls import cho_factor, cho_solve, jacobi
from pint_tpu_torch.models.noise import (
    FYR,
    _tdb_seconds,
    create_fourier_design_matrix,
    powerlaw,
)
from pint_tpu_torch.parallel.pta import (
    STACK_KEYS,
    PulsarProblem,
    _assemble_normal,
    _outer,
    build_problem,
    stack_problems,
    upload,
)
from pint_tpu_torch.pta.metrics import PTAMetrics
from pint_tpu_torch.pta.shard import mesh_devices, run_batch

__all__ = ["GWBLikelihood", "gwb_basis", "gwb_blocks_np",
           "gwb_loglik_np", "gwb_phi", "gwb_sweep_driver",
           "hd_matrix", "pulsar_positions"]


# -- geometry ----------------------------------------------------------

def pulsar_positions(models: Sequence) -> np.ndarray:
    """(P, 3) unit sky vectors from each model's astrometry
    (RAJ/DECJ, or ELONG/ELAT rotated by the mean obliquity — the HD
    matrix only consumes angular separations, so the frame just has
    to be common)."""
    out = []
    for m in models:
        raj = getattr(m, "RAJ", None)
        if raj is not None and raj.value is not None:
            a, d = raj.value, m.DECJ.value
            out.append((math.cos(d) * math.cos(a),
                        math.cos(d) * math.sin(a), math.sin(d)))
            continue
        elong = getattr(m, "ELONG", None)
        if elong is not None and elong.value is not None:
            lam, bet = elong.value, m.ELAT.value
            x = math.cos(bet) * math.cos(lam)
            y = math.cos(bet) * math.sin(lam)
            z = math.sin(bet)
            eps = math.radians(23.4392911)
            out.append((x, y * math.cos(eps) - z * math.sin(eps),
                        y * math.sin(eps) + z * math.cos(eps)))
            continue
        raise ValueError(
            "GWB likelihood needs sky positions: model "
            f"{getattr(m, 'name', '?')} has neither RAJ/DECJ nor "
            "ELONG/ELAT")
    return np.asarray(out, dtype=np.float64)


def hd_matrix(positions: np.ndarray) -> np.ndarray:
    """Hellings–Downs overlap-reduction matrix Gamma_ab for unit sky
    vectors (P, 3): with x = (1 - cos zeta_ab)/2,

        Gamma_ab = 3/2 x ln x - x/4 + 1/2   (a != b)
        Gamma_aa = 1                        (pulsar term: + 1/2)
    """
    pos = np.asarray(positions, dtype=np.float64)
    c = np.clip(pos @ pos.T, -1.0, 1.0)
    x = (1.0 - c) / 2.0
    safe = np.where(x > 0.0, x, 1.0)
    g = 1.5 * x * np.log(safe) - x / 4.0 + 0.5
    np.fill_diagonal(g, 1.0)
    return g


# -- common-process basis ----------------------------------------------

def gwb_basis(toas_list: Sequence, nfreq: int):
    """Common-span Fourier basis for the array: ONE reference epoch
    (the array's earliest TDB day) and ONE Tspan pin the frequencies
    and phases across pulsars (a per-pulsar span would rotate each
    sin/cos pair and the cross-correlation would couple mismatched
    modes).

    Returns (U_list, fcols, tspan_s): per-pulsar (n_a, 2*nfreq) basis
    blocks, the per-COLUMN frequencies [Hz], and the common span [s].
    """
    for t in toas_list:
        if getattr(t, "tdb_day", None) is None:
            t.compute_TDBs()
    ref_day = min(float(np.min(t.tdb_day)) for t in toas_list)
    ts = [_tdb_seconds(t, ref_day=ref_day) for t in toas_list]
    lo = min(float(t.min()) for t in ts)
    hi = max(float(t.max()) for t in ts)
    tspan = hi - lo
    if not (tspan > 0.0):
        raise ValueError("GWB basis needs a positive common Tspan")
    U_list = []
    fcols = None
    for t in ts:
        U, fc = create_fourier_design_matrix(t, int(nfreq),
                                             Tspan=tspan)
        U_list.append(U)
        fcols = fc
    return U_list, np.asarray(fcols, dtype=np.float64), float(tspan)


def gwb_phi(fcols: np.ndarray, tspan: float, log10_A: float,
            gamma: float) -> np.ndarray:
    """Per-column prior weights [s^2] of the common process — the
    PLRedNoise convention exactly: powerlaw PSD times the bin width
    df = 1/Tspan."""
    return powerlaw(fcols, 10.0 ** float(log10_A), float(gamma)) \
        / float(tspan)


# -- inner stage: per-pulsar blocks (torch batch + numpy mirror) -------

# ranks of the block assembly's outputs (checked by its block plan)
_BLOCK_NDIMS_OUT = (3, 2, 1, 1)


def _gwb_block_batch(M, F, phi, r, nvec, valid, pvalid, U):
    """Every pulsar's GWB coupling blocks from the shared joint-normal
    assembly (the system the batch solve factors, so ``rdr`` here EQUALS
    its chi2 output), for (P, ...) inputs:

        A  = U^T D^{-1} U          (P, m, m)
        x  = U^T D^{-1} r          (P, m)
        rdr = r^T D^{-1} r         (P,)
        ld  = logdet D             (P,; improper-prior constant dropped)

    with D^{-1} applied through the Woodbury identity on the
    preconditioned Cholesky of Sigma. The logdet undoes the column
    scaling explicitly: logdet Sigma_true = logdet Sigma_scaled
    + 2 sum_j pvalid_j log(colmax_j norm_j). Fully padded batch slots
    (valid = pvalid = 0, unit nvec/phi, zero U) give exact zeros."""
    Sigma, b, w, colmax, norm = _assemble_normal(
        M, F, phi, r, nvec, valid, pvalid)
    d = jacobi(Sigma)
    L = cho_factor(Sigma / _outer(d))
    Mn = (M * pvalid[..., None, :]) / colmax[..., None, :] \
        / norm[..., None, :]
    big = torch.cat([Mn, F], dim=-1)
    colvalid = torch.cat([pvalid, torch.ones_like(phi)], dim=-1)
    Uw = U * w[..., :, None]
    V = (big.mT @ Uw) * colvalid[..., :, None]
    u = (Uw.mT @ r[..., :, None])[..., 0]
    G = U.mT @ Uw
    SinvV = cho_solve(L, V / d[..., :, None]) / d[..., :, None]
    A = G - V.mT @ SinvV
    x = u - (SinvV.mT @ b[..., :, None])[..., 0]
    xhat = cho_solve(L, b / d) / d
    rdr = torch.sum(r * r * w, dim=-1) - torch.sum(xhat * b, dim=-1)
    ldSigma = 2.0 * torch.sum(torch.log(d), dim=-1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    ld = torch.sum(valid * torch.log(nvec), dim=-1) + \
        torch.sum(torch.log(phi), dim=-1) + ldSigma + \
        2.0 * torch.sum(pvalid * torch.log(colmax * norm), dim=-1)
    return A, x, rdr, ld


def _gwb_block_one_np(M, F, phi, r, nvec, valid, pvalid, U):
    """Numpy mirror of one slot of ``_gwb_block_batch`` (identical
    masked algebra, scipy Cholesky) — the oracle's inner stage."""
    from scipy.linalg import cho_factor, cho_solve

    p = M.shape[1]
    q = F.shape[1]
    w = valid / nvec
    Mm = M * pvalid[None, :]
    colmax = np.max(np.abs(Mm), axis=0)
    colmax = np.where(colmax == 0, 1.0, colmax)
    Ms = Mm / colmax[None, :]
    norm = np.sqrt(np.sum(Ms * Ms * w[:, None], axis=0))
    norm = np.where(norm == 0, 1.0, norm)
    Mn = Ms / norm[None, :]
    big = np.concatenate([Mn, F], axis=1)
    bigw = big * w[:, None]
    Sigma = big.T @ bigw
    prior = np.concatenate([np.zeros(p), 1.0 / phi])
    Sigma = Sigma + np.diag(prior)
    colvalid = np.concatenate([pvalid, np.ones(q)])
    Sigma = Sigma * np.outer(colvalid, colvalid) + \
        np.diag(1.0 - colvalid)
    b = bigw.T @ r * colvalid
    d = np.sqrt(np.diagonal(Sigma)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    cf = cho_factor(Sigma / np.outer(d, d), lower=True)
    Uw = U * w[:, None]
    V = (big.T @ Uw) * colvalid[:, None]
    u = Uw.T @ r
    G = U.T @ Uw
    SinvV = cho_solve(cf, V / d[:, None]) / d[:, None]
    A = G - V.T @ SinvV
    x = u - SinvV.T @ b
    xhat = cho_solve(cf, b / d) / d
    rdr = float(np.sum(r * r * w) - xhat @ b)
    ldSigma = 2.0 * float(np.sum(np.log(d))) + \
        2.0 * float(np.sum(np.log(np.diagonal(cf[0]))))
    ld = float(np.sum(valid * np.log(nvec)) + np.sum(np.log(phi)) +
               ldSigma + 2.0 * np.sum(pvalid *
                                      np.log(colmax * norm)))
    return A, x, rdr, ld


def gwb_blocks_np(stacked: dict, U: np.ndarray):
    """Batched numpy inner stage: (A (P,m,m), x (P,m), rdr (P,),
    ld (P,))."""
    P = stacked["M"].shape[0]
    outs = [_gwb_block_one_np(stacked["M"][k], stacked["F"][k],
                              stacked["phi"][k], stacked["r"][k],
                              stacked["nvec"][k],
                              stacked["valid"][k],
                              stacked["pvalid"][k], U[k])
            for k in range(P)]
    return (np.stack([o[0] for o in outs]),
            np.stack([o[1] for o in outs]),
            np.asarray([o[2] for o in outs]),
            np.asarray([o[3] for o in outs]))


# -- outer stage: cross-correlated Schur system ------------------------

def _outer_system(A, Ginv, phi_g):
    """The K outer systems S = Gamma^{-1} ⊗ diag(1/phi_g[k]) +
    blockdiag(A), (K, P*m, P*m), for blocks A (P, m, m), Gamma^{-1}
    (P, P) and prior weights phi_g (K, m): S[k, a, i, b, j] =
    Ginv[a, b] delta_ij / phi_g[k, i], then A[a] added on the diagonal
    blocks through the strided view S[k, a, :, a, :] (the view's axes
    are (k, i, j, a))."""
    P, m = A.shape[0], A.shape[-1]
    K = phi_g.shape[0]
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    S = Ginv[None, :, None, :, None] * \
        (eye_m[None, None, :, None, :] / phi_g[:, None, :, None, None])
    S.diagonal(dim1=1, dim2=3).add_(A.permute(1, 2, 0))
    return S.reshape(K, P * m, P * m)


def _gwb_outer_batch(A, x, rdr_sum, ld_sum, Gamma, fcols, tspan,
                     log10A, gamma):
    """log L at each of the K grid points (log10A[k], gamma[k]) (K,
    tensors) from the assembled blocks A (P, m, m) and x (P, m): factor
    Gamma once, then build and factor the K (P*m)^2 second-stage Schur
    systems S = Gamma^{-1} ⊗ diag(1/phi_g) + blockdiag(A) as one batch.
    ``rdr_sum``, ``ld_sum`` and ``tspan`` are Python floats (kernel
    arguments, no copy to the device). phi_g is ``models.noise.powerlaw``
    times df = 1/Tspan."""
    P, m = x.shape
    eye = torch.eye(P, dtype=x.dtype, device=x.device)
    LG = cho_factor(Gamma)
    Ginv = cho_solve(LG, eye)
    ldG = 2.0 * torch.sum(torch.log(torch.diagonal(LG)))
    la, ga = log10A[:, None], gamma[:, None]
    phi_g = torch.pow(10.0, la) ** 2 / (12.0 * math.pi ** 2) * \
        torch.pow(FYR, ga - 3.0) * fcols ** (-ga) / tspan          # (K, m)
    S = _outer_system(A, Ginv, phi_g)
    d = jacobi(S)
    L = cho_factor(S.div_(_outer(d)))
    y = x.reshape(P * m) / d
    quad = torch.sum(y * cho_solve(L, y), dim=-1)
    ldS = 2.0 * torch.sum(torch.log(d), dim=-1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (rdr_sum - quad + ld_sum + m * ldG +
                   P * torch.sum(torch.log(phi_g), dim=-1) + ldS)


def _gwb_outer_np(A, x, rdr_sum, ld_sum, Gamma, fcols, tspan,
                  log10A, gamma):
    """Numpy mirror of ``_gwb_outer_batch`` — the oracle's outer stage
    and the ``pool="host"`` sweep."""
    from scipy.linalg import cho_factor, cho_solve

    P, m = x.shape
    cfG = cho_factor(Gamma, lower=True)
    Ginv = cho_solve(cfG, np.eye(P))
    ldG = 2.0 * float(np.sum(np.log(np.diagonal(cfG[0]))))
    xs = x.reshape(P * m)
    out = np.zeros(len(log10A))
    for k, (la, ga) in enumerate(zip(log10A, gamma)):
        phi_g = powerlaw(fcols, 10.0 ** float(la), float(ga)) \
            / float(tspan)
        S = np.kron(Ginv, np.diag(1.0 / phi_g))
        S4 = S.reshape(P, m, P, m)
        for a in range(P):
            S4[a, :, a, :] += A[a]
        S = S4.reshape(P * m, P * m)
        d = np.sqrt(np.diagonal(S)).copy()
        d[(d == 0) | ~np.isfinite(d)] = 1.0
        cf = cho_factor(S / np.outer(d, d), lower=True)
        quad = float((xs / d) @ cho_solve(cf, xs / d))
        ldS = 2.0 * float(np.sum(np.log(d))) + \
            2.0 * float(np.sum(np.log(np.diagonal(cf[0]))))
        out[k] = -0.5 * (rdr_sum - quad + ld_sum + m * ldG +
                         P * float(np.sum(np.log(phi_g))) + ldS)
    return out


def gwb_loglik_np(stacked: dict, U: np.ndarray, Gamma: np.ndarray,
                  fcols: np.ndarray, tspan: float,
                  log10A: np.ndarray, gamma: np.ndarray):
    """Full numpy mirror: inner blocks + cross-correlated outer
    stage, end to end on the host — the CPU oracle of the device
    path."""
    A, x, rdr, ld = gwb_blocks_np(stacked, U)
    return _gwb_outer_np(A, x, float(rdr.sum()), float(ld.sum()),
                         np.asarray(Gamma), np.asarray(fcols),
                         float(tspan), np.asarray(log10A),
                         np.asarray(gamma))


# -- the likelihood object ---------------------------------------------

class GWBLikelihood:
    """Array-level GWB marginal likelihood over fixed per-pulsar
    linearized problems.

    Blocks are assembled ONCE on ``device`` (the GPU by default; the
    hyperparameters never touch the inner stage), or, with ``mesh``
    (``pta.shard.Mesh``), per contiguous block of pulsars on each
    device of the mesh's ``axis`` with zero cross-block traffic (the
    mesh's first device is then the default ``device``, where the
    outer stage runs), then ``loglik_grid``
    sweeps (log10_A, gamma) points through chunks of the outer Schur
    system. Every device call rides the dispatch supervisor
    (``supervisor``, the process-global one by default) with the numpy
    mirror as labelled host failover; ``pool="host"`` runs the mirror
    instead, by the caller's choice."""

    def __init__(self, pairs: Optional[Sequence] = None,
                 problems: Optional[Sequence[PulsarProblem]] = None,
                 positions: Optional[np.ndarray] = None,
                 gamma_matrix: Optional[np.ndarray] = None,
                 nfreq: int = 10, device=None, mesh=None,
                 axis: str = "pulsar",
                 metrics: Optional[PTAMetrics] = None,
                 supervisor=None, track_mode=None):
        self.mesh, self.axis = mesh, axis
        home = None if mesh is None else mesh_devices(mesh, axis)[0]
        self.device = resolve_device(device) \
            if home is None or device is not None else home
        if problems is None:
            if pairs is None:
                raise ValueError("need pairs or problems")
            problems = [build_problem(t, m, track_mode=track_mode)
                        for t, m in pairs]
        self.problems = list(problems)
        P = len(self.problems)
        if P < 2:
            raise ValueError("a pulsar-ARRAY likelihood needs >= 2 "
                             "pulsars")
        if gamma_matrix is None:
            if positions is None:
                models = [pr.model for pr in self.problems]
                if any(m is None for m in models):
                    raise ValueError(
                        "problems carry no models: pass positions= "
                        "or gamma_matrix=")
                positions = pulsar_positions(models)
            gamma_matrix = hd_matrix(positions)
        self.Gamma = np.asarray(gamma_matrix, dtype=np.float64)
        if self.Gamma.shape != (P, P):
            raise ValueError(
                f"gamma_matrix shape {self.Gamma.shape} != ({P},{P})")
        toas_list = [pr.toas for pr in self.problems]
        if any(t is None for t in toas_list):
            raise ValueError("problems carry no TOAs (build them via "
                             "build_problem) — the common-span GWB "
                             "basis needs the TOA epochs")
        U_list, self.fcols, self.tspan = gwb_basis(toas_list,
                                                   int(nfreq))
        self.nfreq = int(nfreq)
        self.m = 2 * self.nfreq
        self.stacked = stack_problems(self.problems)
        N = self.stacked["M"].shape[1]
        self.U = np.zeros((P, N, self.m))
        for k, Uk in enumerate(U_list):
            self.U[k, :Uk.shape[0], :] = Uk
        self.metrics = metrics if metrics is not None else \
            PTAMetrics()
        self._supervisor = supervisor
        self._blocks = None
        self.blocks_info: dict = {}

    @property
    def npulsars(self) -> int:
        return len(self.problems)

    def _sup(self):
        if self._supervisor is not None:
            return self._supervisor
        from pint_tpu_torch.runtime import get_supervisor

        return get_supervisor()

    def build_blocks(self, pool: str = "device", force: bool = False):
        """Assemble (A, x, rdr_sum, ld_sum) as host arrays in ONE
        supervised dispatch (key ``pta.gwb_blocks``): on the device, one
        upload, one batched assembly and one read back (over a mesh, one
        upload and one assembly per block of pulsars, every block issued
        before the read back, the first P rows kept), with the numpy
        mirror as host failover; with ``pool="host"``, the mirror,
        pinned. Cached: the GWB hyperparameters never reach this stage.
        ``blocks_info['used_pool']`` labels who served ("device",
        "host" or "host-failover")."""
        from pint_tpu_torch import obs

        if self._blocks is not None and not force:
            return self._blocks
        fell_over = []

        mesh, axis = self.mesh, self.axis

        def run():
            return run_batch(_gwb_block_batch, dict(self.stacked, U=self.U),
                             STACK_KEYS + ("U",), name="pta.gwb_blocks",
                             ndims_out=_BLOCK_NDIMS_OUT, mesh=mesh,
                             axis=axis, device=self.device)

        def host():
            return gwb_blocks_np(self.stacked, self.U)

        def host_counted():
            fell_over.append(True)
            return host()

        with obs.span("pta.gwb_blocks", npulsars=self.npulsars, m=self.m,
                      sharded=mesh is not None):
            if pool == "host":
                A, x, rdr, ld = self._sup().dispatch(
                    host, key="pta.gwb_blocks", pinned=True)
            else:
                A, x, rdr, ld = self._sup().dispatch(
                    run, key="pta.gwb_blocks", device=self.device,
                    fallback=host_counted)
        used = "host" if pool == "host" else \
            ("host-failover" if fell_over else "device")
        self.blocks_info = {"used_pool": used}
        self.metrics.bump("block_assemblies")
        self._blocks = (A, x, float(np.sum(rdr)), float(np.sum(ld)))
        return self._blocks

    def loglik_grid(self, log10A, gamma, chunk: Optional[int] = None,
                    pool: str = "device", sync: bool = True,
                    info: Optional[dict] = None, progress=None,
                    key_tag: str = "pta.gwb"):
        """log L at each grid point, swept in chunks of
        ``config.gwb_chunk()`` supervised dispatches (a chunk boundary
        is a failover and deadline boundary). ``sync=False`` returns a
        zero-arg collect, with chunk 0 already issued."""
        from pint_tpu_torch import config

        K = int(chunk) if chunk else config.gwb_chunk()
        collect = gwb_sweep_driver(
            self, np.asarray(log10A, dtype=np.float64).ravel(),
            np.asarray(gamma, dtype=np.float64).ravel(), K, pool=pool,
            sync=sync, info=info, progress=progress,
            supervisor=self._sup(), key_tag=key_tag)
        if sync:
            return collect()
        return collect

    def loglik(self, log10_A: float, gamma: float,
               **kw) -> float:
        """Single-point log L (a grid of one)."""
        return float(self.loglik_grid([log10_A], [gamma], **kw)[0])


def gwb_sweep_driver(like: GWBLikelihood, log10A: np.ndarray,
                     gamma: np.ndarray, K: int, pool: str = "device",
                     sync: bool = True, info: Optional[dict] = None,
                     progress=None, supervisor=None,
                     key_tag: str = "pta.gwb"):
    """Chunked supervised sweep of the outer Schur system: each chunk of
    K grid points is its own deadline-bounded dispatch (key
    ``<key_tag>/chunk<c>``) on the likelihood's device, with the numpy
    outer mirror as host failover (the blocks are host arrays already,
    so a device that dies mid-sweep finishes on the host from the chunk
    boundary); ``pool="host"`` runs the mirror, pinned. Each chunk's
    values are read back before ``progress`` (points done) fires, and
    ``info['used_pool']`` labels who served. The last chunk pads by
    repeating the final point (dropped on gather). The blocks, Gamma
    and the frequencies go to the device once. ``sync=False`` issues
    chunk 0 on the supervisor's async path and returns ``collect``,
    which reads it and runs the rest."""
    from pint_tpu_torch import obs

    if supervisor is None:
        supervisor = like._sup()
    if info is None:
        info = {}
    npts = len(log10A)
    if npts == 0:
        def empty():
            info["used_pool"] = pool if pool == "host" else "device"
            return np.zeros(0)
        return empty
    nchunks = -(-npts // K)
    A, x, rdr_sum, ld_sum = like.build_blocks(pool=pool)
    if like.blocks_info.get("used_pool") == "host-failover":
        info["used_pool"] = "host-failover"
    la = np.full(nchunks * K, log10A[npts - 1])
    ga = np.full(nchunks * K, gamma[npts - 1])
    la[:npts] = log10A
    ga[:npts] = gamma
    fell_over: List[bool] = []
    placed: dict = {}

    def closures(c):
        sl = slice(c * K, (c + 1) * K)

        def run():
            if not placed:
                placed.update(upload(
                    {"A": A, "x": x, "G": like.Gamma, "f": like.fcols},
                    ("A", "x", "G", "f"), like.device))
            la_c, ga_c = (torch.from_numpy(a[sl]).to(like.device)
                          for a in (la, ga))
            return _gwb_outer_batch(
                placed["A"], placed["x"], rdr_sum, ld_sum, placed["G"],
                placed["f"], like.tspan, la_c, ga_c)

        def run_pinned():
            return _gwb_outer_np(A, x, rdr_sum, ld_sum, like.Gamma,
                                 like.fcols, like.tspan, la[sl], ga[sl])

        def host_counted():
            fell_over.append(True)
            return run_pinned()  # graftlint: allow G6 -- inside the host failover the supervisor itself runs (fallback=host_counted): the numpy mirror on the host, no device call

        return run, run_pinned, host_counted

    def issue(c, asynchronous=False):
        run, run_pinned, host_counted = closures(c)
        key = f"{key_tag}/chunk{c}"
        if pool == "host":
            return supervisor.dispatch(run_pinned, key=key, steps=K,
                                       pinned=True)
        if asynchronous:
            return supervisor.dispatch_async(
                run, key=key, steps=K, fallback=host_counted,
                device=like.device)
        return supervisor.dispatch(run, key=key, steps=K,
                                   fallback=host_counted,
                                   device=like.device)

    def gather(first):
        vals: List[np.ndarray] = []
        for c in range(nchunks):
            with obs.span("pta.gwb_sweep", chunk=c, points=K, pool=pool):
                out = first.result() if c == 0 and first is not None \
                    else issue(c)
            like.metrics.bump("gwb_solves")
            like.metrics.bump("hd_outer_solves", K)
            vals.append(out.cpu().numpy() if torch.is_tensor(out)
                        else np.asarray(out))
            if progress is not None:
                progress(min(npts, (c + 1) * K))
        if pool == "host":
            info["used_pool"] = "host"
        elif info.get("used_pool") != "host-failover":
            info["used_pool"] = "host-failover" if fell_over else "device"
        return np.concatenate(vals)[:npts]

    if sync or pool == "host":
        return lambda: gather(None)
    with obs.span("pta.gwb_sweep.issue", chunk=0, points=K):
        first = issue(0, asynchronous=True)
    return lambda: gather(first)
