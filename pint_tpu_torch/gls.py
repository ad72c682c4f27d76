"""Generalized-least-squares fitters (a port of pint_tpu/gls.py;
reference: src/pint/fitter.py GLSFitter basis/Woodbury branch,
DownhillGLSFitter).

    M (N,p)  design matrix, unit-normalized columns, Offset prepended
    F (N,q)  stacked noise bases;  phi (q,) their prior variances
    Nvec     scaled white variances (EFAC/EQUAD applied)
    Sigma = [M|F]^T N^-1 [M|F] + diag(0..0, 1/phi)     ((p+q),(p+q))
    xhat  = Sigma^-1 [M|F]^T N^-1 r
    chi2  = r^T N^-1 r - xhat^T [M|F]^T N^-1 r

Every solve is float64 torch on the device of its inputs: the Gram is one
``torch.matmul``, the factorization ``torch.linalg.cholesky_ex`` (a
failed factorization gives NaN, as ``jax.scipy`` does, instead of
raising), so the ``ok`` flag and the eigh fallback behave as in the
reference. ``GLSFitter(full_cov=True)`` solves with the dense N x N
covariance instead (``_gls_kernel_fullcov``), the reference's
cross-check of the Woodbury algebra; it is never the default.

``DeviceDownhillGLSFitter`` runs each downhill trial as one fit step
(``parallel.build_fit_step``, iterated by ``build_fit_loop``), and
``StreamingGLSFitter`` each trial as one pass of the matrix-free
streaming GLS (``parallel.streaming``); both search with ``downhill_dd``
and keep the parameter state on the host in exact dd.

Every device call is a supervised dispatch (``runtime``) under the
reference's keys: ``gls.solve``, ``gls.svd`` and ``gls.fullcov`` (each
a whole linearized pass: residuals, design matrix, noise and solve),
``gls.chi2``, ``gls.fit_step``/``gls.fit_loop`` and the streaming
``stream.chunk``/``stream.solve``. A failover never reads from the
card: a solve's host path rebuilds the pass on the CPU and solves with
the numpy mirrors (``gls_solve_np``, ``_gls_svd_np``,
``_gls_chi2_np``), a whole fit reruns on a CPU-homed model
(``fitter.rehome_to_cpu``).

Numerical health (``obs.health``; $PINT_TPU_HEALTH, $PINT_TPU_SHADOW_RATE):
the Cholesky solve returns a health vector with its result, each solve
and each device-fit dispatch is observed (``gls.solve``,
``wideband.solve``, ``fit.device``, ``stream.chunk``/``stream.solve``),
and GLSFitter's Cholesky solve and the streaming finalize carry a
shadow that replays them on the numpy mirror. A failed Cholesky is never
shadowed, and the designed degenerate route (the eigh retry) is not an
incident.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.fitter import Fitter, MaxiterReached, warn_degenerate
from pint_tpu_torch.ops import dd_np
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.runtime import DispatchError, get_supervisor

__all__ = ["GLSFitter", "DownhillGLSFitter", "DeviceDownhillGLSFitter",
           "StreamingGLSFitter", "NonFiniteStepError", "gls_chi2",
           "gls_solve_np"]


class NonFiniteStepError(ValueError):
    """The Cholesky-only device step (or the streaming CG solve) gave
    non-finite values: a singular or degenerate system. The device
    fitter catches it and falls back to the host fitters, which carry
    the SVD fallback."""


def equilibrate(M, w):
    """(Mn, colmax, norm): the reference's two-stage column scaling —
    by the column max (keeps sum(M^2 w) in range for the ~1e13 s/unit
    spin columns), then to unit weighted norm."""
    Mn, colmax, norm = equilibrate_blocks([M], [w])
    return Mn[0], colmax, norm


def reduce_blocks(parts, op=torch.add):
    """Per-block partials combined in block order on the first block's
    device (the one partial itself when there is one)."""
    home = parts[0].device
    out = parts[0]
    for x in parts[1:]:
        out = op(out, x.to(home))
    return out


def equilibrate_blocks(Ms, ws):
    """``equilibrate`` of the row blocks ``Ms`` (weights ``ws``) of one
    matrix, each block on its own device: the column max and the
    weighted norm are reductions over every row, so both are reduced
    across the blocks (on the first block's device) before any block is
    scaled. Returns ([Mn of each block], colmax, norm)."""
    colmax = reduce_blocks([torch.amax(torch.abs(M), dim=0) for M in Ms],
                           torch.maximum)
    colmax = torch.where(colmax == 0, torch.ones_like(colmax), colmax)
    Ss = [M / colmax.to(M.device)[None, :] for M in Ms]
    norm = torch.sqrt(reduce_blocks([torch.sum(S * S * w[:, None], dim=0)
                                     for S, w in zip(Ss, ws)]))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return [S / norm.to(S.device)[None, :] for S in Ss], colmax, norm


def jacobi(S):
    """sqrt of the diagonal, 1 where it is zero or not finite: the
    unit-diagonal preconditioner of every Cholesky here. ``S`` is one
    (n, n) matrix or a (..., n, n) batch; the result is (..., n)."""
    d = torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1))
    return torch.where((d == 0) | ~torch.isfinite(d), torch.ones_like(d), d)


def cho_factor(A):
    """Lower Cholesky factor of A (n, n) or of each matrix of a
    (..., n, n) batch; all NaN for a matrix that is not positive definite
    (jax.scipy.linalg.cho_factor's behaviour, without a host sync), the
    other matrices of the batch untouched."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def cho_solve(L, b):
    """Solve with the factor L (..., n, n): ``b`` of one dimension fewer
    than L is a vector (a (..., n) batch of vectors), ``b`` of as many a
    matrix of right-hand sides (..., n, k). A batch is solved by two
    triangular solves: torch's batched ``cholesky_solve`` on CUDA goes
    through MAGMA, which synchronizes the stream around the call (on the
    CPU the two are bitwise equal)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    if L.ndim == 2:
        x = torch.cholesky_solve(b, L)
    else:
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if vec else x


def _symm_mm(X, Y, f32: bool = False):
    """X^T @ Y, the Gram products of the normal equations (``Y`` a
    matrix or a vector); the result is always float64. With ``f32`` the
    operands are rounded to float32 and multiplied in float32 (the
    matmul_f32 route: no TF32, see ``_gls_kernel``); without it they are
    upcast and accumulated in float64 (a no-op on float64 operands). The
    one seam where a test can force a demotion."""
    if not f32:
        return X.to(torch.float64).T @ Y.to(torch.float64)
    return (X.to(torch.float32).T @ Y.to(torch.float32)).to(torch.float64)


def _gls_kernel(M, F, phi, r, nvec, health: bool = False,  # graftlint: allow G14 -- the producer: the kernel computes the health vector on the device and returns it; the fitters' dispatch sites hand it to HealthMonitor.observe
                f32mm: bool = False):
    """Basis-Woodbury GLS solve. Returns (dparams, cov_pp, chi2,
    noise_resid, xhat_full, ok) — ok False when the Cholesky failed or
    its solve does not check out (callers then use the eigh solve).
    ``f32mm`` takes the Gram products in float32 (the matmul_f32 route,
    ``parallel.fit_step._use_f32_matmul``), which needs torch's float32
    matmul precision "highest" and TF32 off, torch's defaults.

    With ``health`` a seventh output follows: the health vector
    [nonfinite count, max |r|/sigma, chi2, relative residual of the
    preconditioned solve] (``obs.health``); without it, the ops of the
    health-free solve."""
    p = M.shape[1]
    w = 1.0 / nvec
    Mn, colmax, norm = equilibrate(M, w)
    big = torch.cat([Mn, F], dim=1)
    sw = torch.sqrt(w)
    bigs = big * sw[:, None]
    if f32mm:
        Sigma = _symm_mm(bigs, bigs, True)
        b = _symm_mm(bigs, (r * sw)[:, None], True)[:, 0]
    else:
        Sigma = _symm_mm(bigs, bigs)
        b = _symm_mm(bigs, (r * sw)[:, None])[:, 0]
    prior = torch.cat([torch.zeros(p, dtype=M.dtype, device=M.device),
                       1.0 / phi])
    Sigma = Sigma + torch.diag(prior)
    d = jacobi(Sigma)
    dd = torch.outer(d, d)
    L = cho_factor(Sigma / dd)
    xhat = cho_solve(L, b / d) / d
    eye = torch.eye(Sigma.shape[0], dtype=M.dtype, device=M.device)
    inv = cho_solve(L, eye) / dd
    chi2 = torch.sum(r * r * w) - xhat @ b
    dparams = xhat[:p] / colmax / norm
    cov = inv[:p, :p] / torch.outer(colmax, colmax) \
        / torch.outer(norm, norm)
    noise_resid = F @ xhat[p:]
    # ok catches the finite-garbage case of a (nearly) singular Sigma as
    # well: the relative residual of the preconditioned solve
    solve_err = torch.linalg.norm((Sigma / dd) @ (d * xhat) - b / d)
    ok = (torch.all(torch.isfinite(xhat)) & torch.all(torch.isfinite(cov))
          & (solve_err <= 1e-6 * (torch.linalg.norm(b / d) + 1.0)))
    if not health:
        return dparams, cov, chi2, noise_resid, xhat, ok
    rel = solve_err / (torch.linalg.norm(b / d) + 1.0)
    hv = torch.stack([
        (torch.sum(~torch.isfinite(xhat)) + torch.sum(~torch.isfinite(chi2))
         ).to(torch.float64),
        torch.max(torch.abs(r) / torch.sqrt(nvec)),
        chi2,
        rel,
    ])
    return dparams, cov, chi2, noise_resid, xhat, ok, hv


class _Held:
    """Tensors that ride back from a guarded dispatch as they are: the
    supervisor's host read walks tuples, lists and dicts, not this, so
    a shadow's inputs stay on the device until a due replay reads
    them on its background thread."""

    __slots__ = ("tensors",)

    def __init__(self, tensors):
        self.tensors = tensors


def _gls_kernel_svd(M, F, phi, r, nvec, threshold=1e-12):
    """Eigendecomposition solve of the same normal equations, Jacobi-
    preconditioned to unit diagonal so genuine degeneracies are exactly
    the small eigenvalues (reference: GLSFitter threshold branch)."""
    p = M.shape[1]
    w = 1.0 / nvec
    Mn, colmax, norm = equilibrate(M, w)
    big = torch.cat([Mn, F], dim=1)
    bigw = big * w[:, None]
    Sigma = big.T @ bigw
    prior = torch.cat([torch.zeros(p, dtype=M.dtype, device=M.device),
                       1.0 / phi])
    Sigma = Sigma + torch.diag(prior)
    b = bigw.T @ r
    d = jacobi(Sigma)
    dd = torch.outer(d, d)
    s, U = torch.linalg.eigh(Sigma / dd)
    keep = s > threshold * s[-1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    xhat = (U @ (s_inv * (U.T @ (b / d)))) / d
    inv = ((U * s_inv[None, :]) @ U.T) / dd
    chi2 = torch.sum(r * r * w) - xhat @ b
    dparams = xhat[:p] / colmax / norm
    cov = inv[:p, :p] / torch.outer(colmax, colmax) \
        / torch.outer(norm, norm)
    return dparams, cov, chi2, F @ xhat[p:], xhat


def _gls_chi2_kernel(F, phi, r, nvec):
    """chi2 at a parameter point: r^T C^-1 r with C = diag(nvec) +
    F diag(phi) F^T, via Woodbury in basis space — the downhill
    accept/reject criterion (reference: GLSState.chi2)."""
    w = 1.0 / nvec
    Fw = F * w[:, None]
    bF = Fw.T @ r
    Sff = F.T @ Fw + torch.diag(1.0 / phi)
    d = jacobi(Sff)
    L = cho_factor(Sff / torch.outer(d, d))
    return torch.sum(r * r * w) - bF @ (cho_solve(L, bF / d) / d)


def _gls_kernel_fullcov(M, F, phi, r, nvec):
    """Dense full-covariance GLS (reference: the full_cov=True branch):
    C = diag(Nvec) + F diag(phi) F^T, solved through a Cholesky factor
    of C. Returns (dparams, cov, chi2, noise_resid). O(N^2) memory: an
    accuracy cross-check of the Woodbury solve, not the default."""
    C = torch.diag(nvec) + (F * phi[None, :]) @ F.T
    L = cho_factor(C)
    norm = torch.sqrt(torch.sum(M * M, dim=0))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    Mn = M / norm[None, :]
    CiM = cho_solve(L, Mn)
    Cir = cho_solve(L, r)
    Sigma = Mn.T @ CiM
    b = Mn.T @ Cir
    L2 = cho_factor(Sigma)
    xhat = cho_solve(L2, b)
    eye = torch.eye(Sigma.shape[0], dtype=M.dtype, device=M.device)
    inv = cho_solve(L2, eye)
    chi2 = r @ Cir - xhat @ b
    # conditional mean of the GP: phi F^T C^-1 (r - M dθ) ≈ phi F^T C^-1 r
    noise_resid = (F * phi[None, :]) @ (F.T @ Cir)
    return xhat / norm, inv / torch.outer(norm, norm), chi2, noise_resid


def _gls_chi2_np(F, phi, r, nvec) -> float:
    """Numpy mirror of _gls_chi2_kernel — the supervised dispatch's
    host-failover path (same Woodbury-in-basis-space algebra with
    scipy cho_factor; a copy of the reference's)."""
    from scipy.linalg import cho_factor as _cf, cho_solve as _cs

    w = 1.0 / nvec
    bF = (F * w[:, None]).T @ r
    Sff = F.T @ (F * w[:, None]) + np.diag(1.0 / phi)
    d = np.sqrt(np.diagonal(Sff)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    cf = _cf(Sff / np.outer(d, d), lower=True)
    return float(np.sum(r * r * w)
                 - bF @ (_cs(cf, bF / d) / d))


def gls_solve_np(M, F, phi, r, nvec):
    """Pure-numpy mirror of _gls_kernel: the same two-stage
    equilibration, Jacobi-scaled Cholesky and chi2 with scipy (a copy
    of the reference's). Returns (dparams, cov, chi2, noise_resid)."""
    from scipy.linalg import cho_factor as _cf, cho_solve as _cs

    p = M.shape[1]
    w = 1.0 / nvec
    colmax = np.max(np.abs(M), axis=0)
    colmax[colmax == 0] = 1.0
    Ms = M / colmax[None, :]
    norm = np.sqrt(np.sum(Ms * Ms * w[:, None], axis=0))
    norm[norm == 0] = 1.0
    Mn = Ms / norm[None, :]
    big = np.concatenate([Mn, F], axis=1)
    bigw = big * w[:, None]
    Sigma = big.T @ bigw + np.diag(
        np.concatenate([np.zeros(p), 1.0 / phi]))
    b = bigw.T @ r
    d = np.sqrt(np.diagonal(Sigma)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    cf = _cf(Sigma / np.outer(d, d), lower=True)
    xhat = _cs(cf, b / d) / d
    inv = _cs(cf, np.eye(Sigma.shape[0])) / np.outer(d, d)
    chi2 = float(np.sum(r * r * w) - xhat @ b)
    scale = colmax * norm
    return (xhat[:p] / scale, inv[:p, :p] / np.outer(scale, scale), chi2,
            F @ xhat[p:])


def _gls_svd_np(M, F, phi, r, nvec, threshold=1e-12):
    """Pure-numpy mirror of _gls_kernel_svd (Jacobi-preconditioned eigh,
    small-eigenvalue dropping; a copy of the reference's)."""
    p = M.shape[1]
    w = 1.0 / nvec
    colmax = np.max(np.abs(M), axis=0)
    colmax[colmax == 0] = 1.0
    Ms = M / colmax[None, :]
    norm = np.sqrt(np.sum(Ms * Ms * w[:, None], axis=0))
    norm[norm == 0] = 1.0
    Mn = Ms / norm[None, :]
    big = np.concatenate([Mn, F], axis=1)
    bigw = big * w[:, None]
    Sigma = big.T @ bigw + np.diag(
        np.concatenate([np.zeros(p), 1.0 / phi]))
    b = bigw.T @ r
    d = np.sqrt(np.diagonal(Sigma)).copy()
    d[(d == 0) | ~np.isfinite(d)] = 1.0
    Sp = Sigma / np.outer(d, d)
    s, U = np.linalg.eigh(Sp)
    keep = s > threshold * s[-1]
    s_inv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
    xhat = (U @ (s_inv * (U.T @ (b / d)))) / d
    inv = ((U * s_inv[None, :]) @ U.T) / np.outer(d, d)
    chi2 = float(np.sum(r * r * w) - xhat @ b)
    scale = colmax * norm
    return (xhat[:p] / scale, inv[:p, :p] / np.outer(scale, scale),
            chi2, F @ xhat[p:])


def _gls_host_failover_solve(M, F, phi, r, nvec, threshold=None,
                             what="normal matrix"):
    """Mode-aware host failover solve (a copy of the reference's):
    honor an explicit SVD threshold; try the Cholesky mirror otherwise;
    degrade to the eigh mirror — with the DegeneracyWarning the device
    path emits — when the system is singular enough that Cholesky
    raises or returns non-finites. The full_cov mode lands here too:
    the basis-Woodbury mirror is the same algebra."""
    if threshold is not None:
        return _gls_svd_np(M, F, phi, r, nvec, threshold=float(threshold))
    try:
        x, cov, chi2, noise = gls_solve_np(M, F, phi, r, nvec)
        if np.all(np.isfinite(x)) and np.isfinite(chi2):
            return x, cov, chi2, noise
    except np.linalg.LinAlgError:
        pass
    warn_degenerate(what)
    return _gls_svd_np(M, F, phi, r, nvec)


def _resids_on(toas, model, resids, device):
    """The time residuals on ``device``: ``resids`` (a Residuals, a
    tensor, or None) when it lies there already, else a fresh pass on
    ``device`` from host state (with the Residuals' settings) — never a
    read from another device."""
    if isinstance(resids, Residuals):
        if resids.device == device:
            return resids.time_resids
        return Residuals(toas, model, track_mode=resids.track_mode,
                         subtract_mean=resids.subtract_mean,
                         use_weighted_mean=resids.use_weighted_mean,
                         device=device).time_resids
    if resids is not None and resids.device == device:
        return resids
    return Residuals(toas, model, device=device).time_resids


def gls_chi2(model, toas, resids=None, device=None) -> float:
    """GLS chi2 of current residuals (basis-marginalized), on ``device``
    (the model's by default): one supervised dispatch (``gls.chi2``)
    whose host failover recomputes the residuals on the CPU and takes
    the numpy mirror. ``resids`` is a Residuals (evaluated inside the
    dispatch when it has not been yet), a residual tensor, or None (a
    fresh pass)."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.config import solve_device

    dev = model.device if device is None else resolve_device(device)
    pinned = solve_device(toas.ntoas, dev) is not None
    if pinned:
        dev = torch.device("cpu")
    if not model.has_correlated_errors:
        r = _resids_on(toas, model, resids, dev)
        nvec, _, _ = model.noise_device(toas, dev)
        return float(torch.sum(r ** 2 / nvec))

    def run():
        r = _resids_on(toas, model, resids, dev)
        nvec, F, phi = model.noise_device(toas, dev)
        return _gls_chi2_kernel(F, phi, r, nvec)

    def host():
        cpu = torch.device("cpu")
        r = _resids_on(toas, model, resids, cpu)
        nvec, F, phi = model.noise_device(toas, cpu)
        return _gls_chi2_np(F.numpy(), phi.numpy(), r.numpy(),
                            nvec.numpy())

    with obs.span("gls.chi2", ntoa=toas.ntoas):
        out = get_supervisor().dispatch(run, key="gls.chi2", device=dev,
                                        pinned=pinned, fallback=host)
    return float(out)


class GLSFitter(Fitter):
    """GLS fit with correlated noise marginalized in basis space
    (reference: GLSFitter); with ``full_cov`` every solve uses the dense
    N x N covariance instead.

    Each linearized solve is one supervised dispatch of the whole pass
    (``_system`` and the kernel) under the reference's keys
    (``gls.solve``; ``gls.svd`` for the threshold route and the
    degenerate retry; ``gls.fullcov``). A timed-out, broken or
    breaker-open device fails the solve over to the host: the pass
    rebuilt on the CPU and the numpy mirror
    (``_gls_host_failover_solve``), labelled and counted."""

    _KEY = "gls"                  # dispatch-key prefix
    _WHAT = "normal matrix"       # the DegeneracyWarning's subject
    _SHADOW = "gls"               # health kind of the Cholesky shadow

    def __init__(self, toas, model, residuals=None, track_mode=None,
                 full_cov=False):
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.full_cov = full_cov
        self.noise_resids: Optional[torch.Tensor] = None

    def _system(self, device=None):
        """(M, r, nvec, F, phi, names, state) of the linearized problem
        at the current parameters, float64 tensors on ``device`` (the
        model's by default); ``state`` holds the residual objects the
        fitter keeps ({"resids": ...})."""
        dev = self.device if device is None else device
        res = self._residuals(dev)
        M, names, _ = self.model.designmatrix(self.toas, incoffset=True,
                                              device=dev)
        nvec, Fb, phi = self.model.noise_device(self.toas, dev)
        return M, res.time_resids, nvec, Fb, phi, names, {"resids": res}

    def _solve_once(self, threshold=None):
        """One linearized solve at the current parameters: (x, cov, chi2,
        noise_resid, names), x and cov numpy for the host's parameter
        update, noise_resid the N time-channel rows as a CPU tensor."""
        try:
            out = self._solve_once_device(threshold)
        except DispatchError as e:
            # host failover: the same pass on the CPU and the numpy
            # mirror of the same algebra (mode-aware: the eigh mirror
            # for the threshold route and degenerate systems)
            self._after_failover(f"{self._KEY}.solve", e)
            out = self._solve_once_host(threshold)
        x, cov, chi2, noise, names, state = out
        for k, v in state.items():
            setattr(self, k, v)
        return x, cov, chi2, noise, names

    def _solve_once_device(self, threshold):
        from pint_tpu_torch import config, obs
        from pint_tpu_torch.obs import health as _health

        sup = get_supervisor()
        pinned = self._solve_pinned()
        dev = self._pass_device()
        n = self.toas.ntoas
        health_on = config.health_enabled()
        # shadow sampling armed: the pass's inputs ride back with the
        # Cholesky result, held on the device (``_Held``), and are read
        # only by a replay that is due
        keep = self._SHADOW is not None and \
            _health.get_monitor().shadow_rate > 0

        def run(kernel, held=False, **kw):
            with self._solve_scope():
                M, r, nvec, Fb, phi, names, state = self._system(dev)
                out = kernel(M, Fb, phi, r, nvec, **kw)
                if held:
                    return out, names, state, _Held((M, Fb, phi, r, nvec))
                return out, names, state

        def go(key, kernel, shadow=None, **kw):
            return sup.dispatch(run, kernel, kw=kw, key=key, device=dev,
                                pinned=pinned, shadow=shadow,
                                shadow_kind=self._SHADOW)

        def shadow_chol(res):
            # the numpy mirror of the same algebra on the same inputs;
            # drift = max |d dparams| in sigma of the device covariance.
            # A failed Cholesky (ok False: the designed degenerate
            # route, about to be retried by eigh) carries garbage
            # dparams and is not shadow-applicable
            out = res[0]
            if not bool(out[5]):
                return None
            M, Fb, phi, r, nvec = (x.cpu().numpy() for x in res[3].tensors)
            mx = gls_solve_np(M, Fb, phi, r, nvec)[0]
            return _health.drift_sigma(out[0].cpu().numpy(),
                                       out[1].cpu().numpy(), mx)

        with obs.span(f"{self._KEY}.solve_once",
                      fitter=type(self).__name__, ntoa=n):
            if self.full_cov:
                (x, cov, chi2, noise), names, state = go(
                    f"{self._KEY}.fullcov", _gls_kernel_fullcov)
            elif threshold is not None:
                (x, cov, chi2, noise, _), names, state = go(
                    f"{self._KEY}.svd", _gls_kernel_svd,
                    threshold=float(threshold))
            else:
                from pint_tpu_torch.parallel.fit_step import \
                    _use_f32_matmul

                kw = {"health": True} if health_on else {}
                # the float32 Gram only when asked for
                # ($PINT_TPU_GLS_MATMUL) and the solve is not pinned to
                # the host CPU, whose float64 is native
                if not pinned and _use_f32_matmul(None):
                    kw["f32mm"] = True
                if keep:
                    kw["held"] = True
                res = go(f"{self._KEY}.solve", _gls_kernel,
                         shadow=shadow_chol if keep else None, **kw)
                out, names, state = res[:3]
                x, cov, chi2, noise, _, ok = out[:6]
                hsig = {"values": [x.cpu(), chi2.cpu()]}
                if bool(ok):
                    if health_on:
                        hsig["hv"] = out[6].cpu()
                else:
                    # the designed degenerate route: warn + eigh retry
                    # (a second pass: the first one's device tensors
                    # do not outlive its dispatch), observed with the
                    # FINAL outcome — a handled fallback that succeeds
                    # is not a numerics incident
                    warn_degenerate(self._WHAT)
                    (x, cov, chi2, noise, _), names, state = go(
                        f"{self._KEY}.svd", _gls_kernel_svd)
                    hsig = {"values": [x.cpu(), chi2.cpu()]}
                _health.observe(f"{self._KEY}.solve", hsig,
                                key=f"{self._KEY}.solve",
                                pool="host" if pinned else "device")
        # r ≈ M (θ − θ_true): the correction is −x
        return ((-x).cpu().numpy(), cov.cpu().numpy(), float(chi2),
                noise[:n].cpu(), names, state)

    def _solve_once_host(self, threshold):
        """The host path: the pass on the CPU, solved by the numpy
        mirrors (the full_cov mode by the Woodbury mirror, the same
        algebra)."""
        M, r, nvec, Fb, phi, names, state = self._system(
            torch.device("cpu"))
        x, cov, chi2, noise = _gls_host_failover_solve(
            M.numpy(), Fb.numpy(), phi.numpy(), r.numpy(), nvec.numpy(),
            threshold=threshold, what=self._WHAT)
        return (-x, cov, float(chi2),
                torch.from_numpy(noise[:self.toas.ntoas]), names, state)

    def fit_toas(self, maxiter=1, threshold=None):
        t0 = time.perf_counter()
        for _ in range(max(1, maxiter)):
            x, cov, chi2, noise, names = self._solve_once(threshold)
            self.update_model(x, names)
        # uncertainties, chi2 and noise realization at the final point
        x, cov, chi2, noise, names = self._solve_once(threshold)
        self.set_uncertainties(cov, names)
        self.noise_resids = noise
        self.converged = True
        self._record_stats(chi2, max(1, maxiter), t0)
        return chi2

    def get_noise_resids(self):
        """ML realization of the correlated-noise process [s]."""
        return self.noise_resids


class DownhillGLSFitter(GLSFitter):
    """Step-halving downhill wrapper over the GLS step (reference:
    DownhillGLSFitter)."""

    def _chi2_here(self):
        """chi2 at the current parameter point (basis-marginalized)."""
        return self._residuals().chi2

    def fit_toas(self, maxiter=20, threshold=None, min_lambda=1e-3,
                 required_chi2_decrease=1e-2):
        t0 = time.perf_counter()
        iterations = 0
        best_chi2 = self._chi2_here()
        converged = False
        for _ in range(maxiter):
            iterations += 1
            x, cov, _, noise, names = self._solve_once(threshold)
            lam, accepted = 1.0, False
            while lam >= min_lambda:
                self.update_model(lam * x, names)
                new_chi2 = self._chi2_here()
                if new_chi2 <= best_chi2 + 1e-12:
                    accepted = True
                    break
                self.update_model(-lam * x, names)
                lam /= 2.0
            if not accepted:
                converged = True
                break
            improved = best_chi2 - new_chi2
            best_chi2 = new_chi2
            self.set_uncertainties(cov, names)
            self.noise_resids = noise
            if improved < required_chi2_decrease:
                converged = True
                break
        else:
            raise MaxiterReached(
                f"no convergence in {maxiter} downhill GLS iterations")
        self.converged = converged
        # refresh uncertainties/noise realization at the final point
        x, cov, _, noise, names = self._solve_once(threshold)
        self.set_uncertainties(cov, names)
        self.noise_resids = noise
        self._record_stats(best_chi2, iterations, t0)
        return best_chi2



def _bump(th, tl, d):
    """(th, tl) + d in exact dd, the low part carrying the rounding
    remainder (the host replay of ``build_fit_loop``'s advance)."""
    s = dd_np.add(dd_np.dd(th, tl), dd_np.dd(d))
    return np.asarray(s[0]), np.asarray(s[1])


def downhill_dd(evaluate, advance, th, tl, entry, budget, min_lambda,
                required_chi2_decrease, noff=0):
    """The downhill search over a dd parameter state (th, tl), shared by
    ``build_fit_loop`` and ``StreamingGLSFitter`` (reference: the loop
    body of build_fit_loop; decisions of src/pint/fitter.py
    DownhillFitter): accept a trial iff its chi2 is finite and
    <= best + 1e-12, else halve the step down to ``min_lambda``; stop on
    a rejected iteration, when the improvement is below
    ``required_chi2_decrease``, or after ``budget`` iterations.

    ``evaluate(th, tl) -> (ev, chi2)``: ``ev[0]`` the proposed step
    (Offset first when ``noff``), ``chi2`` a Python float (NaN marks an
    unusable trial). ``advance(th, tl, d)`` is (th, tl) + d in exact dd.
    ``entry`` is ``evaluate`` at the start point; a non-finite entry
    chi2 stops the search before any trial.

    Returns ``(th, tl, ev, best, ledger, stopped, ntrials)``: the
    accepted point, its evaluation and chi2, one ``(delta, lam)`` a
    iteration (``lam`` 0 and ``delta`` None for a rejected one),
    ``stopped`` True unless the budget ended the search, and the trial
    evaluations run."""
    ev, best = entry
    ledger: list = []
    stopped = not math.isfinite(best)
    ntrials = 0
    while not stopped and len(ledger) < budget:
        d = ev[0][noff:]
        lam = 1.0
        while lam >= min_lambda:
            step = lam * d
            thc, tlc = advance(th, tl, step)
            evc, chi2 = evaluate(thc, tlc)
            ntrials += 1
            if math.isfinite(chi2) and chi2 <= best + 1e-12:
                break
            lam /= 2.0
        else:
            ledger.append((None, 0.0))
            stopped = True
            break
        ledger.append((step, lam))
        improved = best - chi2
        th, tl, ev, best = thc, tlc, evc, chi2
        stopped = improved < required_chi2_decrease
    return th, tl, ev, best, ledger, stopped, ntrials


def _sync_model(fitter, th, tl, th0, tl0, names, noff):
    """Move the model's free parameters by the exact dd difference of the
    step slots (th, tl) from the build's (th0, tl0)."""
    total = dd_np.sub(dd_np.dd(th, tl), dd_np.dd(th0, tl0))
    fitter.update_model(np.concatenate([np.zeros(noff),
                                        dd_np.to_f64(total)]), names)


class StreamingGLSFitter(GLSFitter):
    """Matrix-free downhill GLS for TOA counts past the dense design's
    memory (reference: StreamingGLSFitter): each trial point is ONE
    streaming pass, the chunked normal-equation accumulator of
    ``parallel.streaming`` (peak device memory O(chunk + (p+q)^2)) and
    its CG finalize, so the (N, p+q) design is never formed.
    ``Fitter.auto`` routes here from ``config.solve_streaming()`` TOAs
    ($PINT_TPU_STREAM_MIN_TOA).

    The downhill decisions are ``DownhillGLSFitter``'s (accept iff the
    basis-marginalized chi2 at the trial point improves, halve the step
    down to ``min_lambda``, stop below ``required_chi2_decrease``); the
    accept chi2 comes with each pass, so a trial costs exactly one
    pass. The parameter state advances on the host in exact dd and the
    model is synced once at the end. A CG or basis-Cholesky failure on
    the first pass raises ``NonFiniteStepError`` (the dense fitters
    carry the SVD fallback); on a later pass it rejects the trial.

    Each chunk of a pass and each CG finalize is a supervised dispatch
    (``stream.chunk``, ``stream.solve``); a timed-out, broken or
    breaker-open device fails the WHOLE fit over to the numpy streaming
    mirror on a CPU-homed model (``_fit_host_mirror``), labelled and
    counted (reference: the same degradation contract)."""

    def __init__(self, toas, model, residuals=None, track_mode=None,
                 chunk=None, **step_flags):
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.chunk = chunk
        self.step_flags = dict(step_flags)
        self.cg_iters = None          # CG iterations of the last solve
        self.passes = None            # streaming passes of the last fit
        self.cg_iters_per_pass: Optional[list] = None
        self.cg_rel_residual = None   # of the last solve
        self.cg_budget = None         # CG iteration budget of the solves

    def fit_toas(self, maxiter=20, min_lambda=1e-3,
                 required_chi2_decrease=1e-2, cg_tol=1e-13):
        from pint_tpu_torch import obs

        t0 = time.perf_counter()
        self.passes = None
        try:
            with obs.span("fit.streaming", ntoa=self.toas.ntoas,
                          maxiter=maxiter):
                return self._fit_stream(maxiter, min_lambda,
                                        required_chi2_decrease, cg_tol,
                                        t0)
        except DispatchError as e:
            get_supervisor().note_failover("gls.stream_fit", e)
            with obs.span("fit.stream_host_failover",
                          cause=f"{type(e).__name__}: {e}"):
                return self._fit_host_mirror(
                    maxiter, min_lambda, required_chi2_decrease, cg_tol,
                    e, t0)

    def _fit_stream(self, maxiter, min_lambda, required_chi2_decrease,
                    cg_tol, t0):
        from pint_tpu_torch.parallel.streaming import StreamingGLS

        sg = StreamingGLS(self.model, self.toas, chunk=self.chunk,
                          device=self.device, **self.step_flags)
        names = sg.names
        noff = 1 if names and names[0] == "Offset" else 0
        th, tl = sg.th0.copy(), sg.tl0.copy()
        self.cg_budget = sg.default_budget
        effort: list = []   # CG iterations of each pass

        last: list = []     # the newest pass's CG iterations, residual
        best: list = []     # the chi2 of the last pass kept

        def observe_kept(out):
            """The health of a pass the fit keeps: the CG effort and the
            pass's chunk taps in one observation."""
            from pint_tpu_torch.obs import health as _health

            sig = {"cg_iters": int(out[6]), "cg_budget": int(self.cg_budget),
                   "cg_rel_residual": float(out[7]), "ok": bool(out[5]),
                   "chi2": float(out[3]), "values": [out[0], out[2]]}
            hv = sg.last_pass_hv
            if hv is not None:
                sig["nonfinite"] = hv[0]
                sig["rescale"] = hv[1]
            _health.observe("stream.solve", sig, key="stream.solve")

        def one_pass(th_, tl_):
            # the entry pass is observed as it runs; a trial only when
            # the search keeps it (downhill_dd's acceptance test): a
            # rejected overshoot is the damping working, not an incident
            entry_pass = not best
            out = sg.solve(sg.accumulate(th_, tl_, observe=entry_pass),
                           tol=cg_tol, observe=entry_pass)
            effort.append(out[6])
            last[:] = out[6:8]
            # a failed CG solve rejects the trial
            chi2 = float(out[3]) if out[5] else math.nan
            if entry_pass:
                best.append(chi2)
            elif math.isfinite(chi2) and chi2 <= best[-1] + 1e-12:
                best.append(chi2)
                observe_kept(out)
            return out, chi2

        entry = one_pass(th, tl)
        if math.isnan(entry[1]) or not np.all(np.isfinite(entry[0][0])):
            raise NonFiniteStepError(
                "streaming CG solve failed (singular/degenerate system?); "
                "use GLSFitter's SVD fallback")
        th, tl, out, best, ledger, converged, ntrials = downhill_dd(
            one_pass, _bump, th, tl, entry, maxiter, min_lambda,
            required_chi2_decrease, noff)
        self.cg_iters, self.cg_rel_residual = last
        self.cg_iters_per_pass = effort
        self.passes = 1 + ntrials
        _sync_model(self, th, tl, sg.th0, sg.tl0, names, noff)
        self.set_uncertainties(out[1], names)
        self.noise_resids = sg.noise_realization(out[4])
        self.resids = self._residuals()
        self.converged = converged
        self._record_stats(best, max(1, len(ledger)), t0)
        if not converged:
            raise MaxiterReached(
                f"no convergence in {maxiter} streaming downhill "
                f"iterations (model left at the best point found)")
        return best

    def _fit_host_mirror(self, maxiter, min_lambda,
                         required_chi2_decrease, cg_tol, cause, t0):
        """Degraded-but-correct (a port of the reference's): the model
        moves to the CPU, and the same downhill loop runs through the
        pure-numpy streaming mirror (the pass rebuilt on the CPU, the
        chunked numpy accumulate and the numpy CG), the model synced
        before every trial pass — labelled, never silent."""
        from pint_tpu_torch.parallel.streaming import StreamingGLS

        self._rehome(cause)
        warnings.warn(
            f"streaming device fit unavailable ({type(cause).__name__}"
            f": {cause}); failed over to the numpy streaming mirror",
            RuntimeWarning, stacklevel=3)
        sg = StreamingGLS(self.model, self.toas, chunk=self.chunk,
                          device="cpu", **self.step_flags)
        names = sg.names
        noff = 1 if names and names[0] == "Offset" else 0
        effort: list = []
        self.cg_budget = sg.default_budget

        def one_pass():
            out = sg.solve_np(tol=cg_tol)
            effort.append((int(out[6]), float(out[7])))
            return out

        def apply(x, sign=1.0):
            self.update_model(sign * np.concatenate(
                [np.zeros(noff), x]), names)

        dp, cov, _, best, xf, ok, iters, rel = one_pass()
        if not ok or not np.all(np.isfinite(dp)):
            raise NonFiniteStepError(
                "streaming host-mirror solve failed (singular/"
                "degenerate system?)")
        iterations = 0
        converged = False
        maxed_out = False
        npass = 1
        for _ in range(maxiter):
            iterations += 1
            d = np.asarray(dp[noff:], np.float64)
            lam, accepted = 1.0, False
            while lam >= min_lambda:
                apply(lam * d)
                dpc, covc, _, chic, xfc, okc, iters, rel = one_pass()
                npass += 1
                if okc and np.isfinite(chic) and chic <= best + 1e-12:
                    accepted = True
                    break
                apply(lam * d, sign=-1.0)
                lam /= 2.0
            if not accepted:
                converged = True
                break
            improved = best - chic
            dp, cov, best, xf = dpc, covc, chic, xfc
            if improved < required_chi2_decrease:
                converged = True
                break
        else:
            maxed_out = True
        self.cg_iters = int(iters)
        self.cg_rel_residual = float(rel)
        self.cg_iters_per_pass = [it for it, _ in effort]
        self.passes = npass
        self.set_uncertainties(cov, names)
        self.noise_resids = sg.noise_realization(xf)
        self.resids = self._residuals()
        self.converged = converged
        self._record_stats(best, max(1, iterations), t0)
        if maxed_out:
            raise MaxiterReached(
                f"no convergence in {maxiter} streaming downhill "
                f"iterations (host mirror)")
        return best


class DeviceDownhillGLSFitter(GLSFitter):
    """Downhill GLS where every trial is the one-function fit step
    (``parallel.build_fit_step``: phase, design matrix, whitening, ECORR
    downdates, normal equations, Cholesky and the accept chi2 on the
    model's device), one host read per trial instead of the host
    fitter's residuals, design-matrix and solve phases (reference:
    DeviceDownhillGLSFitter). The parameter state advances on the host
    in exact dd, as compensated updates of the packed dd pairs.
    ``wideband=True`` fits the stacked [time; DM] rows.

    The fit is a chain of ``build_fit_loop`` calls of K iterations each,
    each call's ledger replayed on the host and its final step carried
    into the next as the entry, so every point is evaluated once. K is
    ``fit_toas(steps_per_dispatch=K)``, 1 by default; ``whole_fit=True``
    makes it the smallest power of two covering ``maxiter`` (at most 32),
    ``maxiter`` the loop's runtime budget. Both (and ``pipeline``, with
    the reference's buffer donation) exist to hide TPU dispatch latency
    and are kept for the reference's interface: here every call is the
    same host loop over device tensors, so they change neither the
    result nor the cost.

    Each call of the loop is one supervised dispatch: ``gls.fit_step``
    at K = 1, ``gls.fit_loop`` at K > 1 (with ``pipeline=True`` the next
    call is issued by ``dispatch_async`` while the host replays the
    ledger). The whole fit fails over, labelled and counted, to
    ``DownhillGLSFitter`` (or ``WidebandDownhillFitter``):

    - on the CPU, the model moved there first (``fitter.rehome_to_cpu``),
      when the device timed out, broke, lost its context or its breaker
      is open (a ``DispatchError``);
    - on the same device when the Cholesky-only step gave a non-finite
      first step (``NonFiniteStepError``): the card works, and the host
      fitter's solve carries the SVD fallback the step lacks.

    The model moves only after the device loop completes, so a failover
    starts from the pre-fit state and equals the host fitter run
    directly."""

    def __init__(self, toas, model, residuals=None, track_mode=None,
                 wideband=False, whole_fit=None, pipeline=None,
                 **step_flags):
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.wideband = wideband
        self.whole_fit = whole_fit
        self.pipeline = pipeline
        self.step_flags = dict(step_flags, wideband=wideband)
        self.step_evals = None   # step evaluations of the last fit

    def _dof(self) -> int:
        if self.wideband:
            # chi2 sums over 2N stacked TOA+DM measurements
            return 2 * self.toas.ntoas - len(self.model.free_params) - 1
        return super()._dof()

    def fit_toas(self, maxiter=20, min_lambda=1e-3,
                 required_chi2_decrease=1e-2, steps_per_dispatch=None,
                 whole_fit=None, pipeline=None):
        """Without ``steps_per_dispatch``, K = 1 (one step per trial)
        unless whole-fit mode is asked for, here or at construction.
        The model moves only after the device loop completes, so a
        fallback starts from the pre-fit state."""
        from pint_tpu_torch import obs

        t0 = time.perf_counter()
        # reset BEFORE the attempt: after a failover the count reads
        # None (no device evaluations ran), not the previous fit's
        self.step_evals = None
        try:
            with obs.span("fit.device", fitter=type(self).__name__,
                          ntoa=self.toas.ntoas, maxiter=maxiter):
                return self._fit_device(maxiter, min_lambda,
                                        required_chi2_decrease,
                                        steps_per_dispatch, t0,
                                        whole_fit, pipeline)
        except (DispatchError, NonFiniteStepError) as e:
            get_supervisor().note_failover("gls.device_fit", e)
            with obs.span("fit.host_failover",
                          cause=f"{type(e).__name__}: {e}"):
                return self._fit_host_failover(
                    maxiter, min_lambda, required_chi2_decrease, e, t0)

    def _fit_host_failover(self, maxiter, min_lambda,
                           required_chi2_decrease, cause, t0):
        """Rerun the fit through the host downhill fitter — on the CPU
        after a ``DispatchError``, on the same device after a
        non-finite step — and adopt its fitted state."""
        if isinstance(cause, DispatchError):
            self._rehome(cause)
        if self.wideband:
            from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter

            host = WidebandDownhillFitter(self.toas, self.model,
                                          track_mode=self.track_mode)
        else:
            host = DownhillGLSFitter(self.toas, self.model,
                                     track_mode=self.track_mode)
        warnings.warn(
            f"device fit step unusable ({type(cause).__name__}: {cause}); "
            f"fell back to {type(host).__name__} on {host.device}",
            RuntimeWarning, stacklevel=3)
        chi2 = host.fit_toas(maxiter=maxiter, min_lambda=min_lambda,
                             required_chi2_decrease=required_chi2_decrease)
        self.resids = host.resids
        self.errors = host.errors
        self.parameter_covariance_matrix = host.parameter_covariance_matrix
        self.noise_resids = host.noise_resids
        if self.wideband:
            self.dm_resids = host.dm_resids
        self.converged = host.converged
        self.stats = host.stats
        if self.stats is not None:
            # the wall of the whole attempt, the failed start included
            wall = time.perf_counter() - t0
            self.stats.wall_time_s = wall
            self.stats.toas_per_sec = (
                self.stats.ntoa * max(1, self.stats.iterations) / wall
                if wall else 0.0)
        return chi2

    def _fit_device(self, maxiter, min_lambda, required_chi2_decrease,
                    steps_per_dispatch, t0, whole_fit=None, pipeline=None):
        from pint_tpu_torch.parallel import build_fit_loop

        whole = bool(whole_fit if whole_fit is not None else self.whole_fit)
        if pipeline is None:
            pipeline = self.pipeline
        if steps_per_dispatch is None:
            steps_per_dispatch = 1
            if whole:
                k = 4
                while k < maxiter and k < 32:
                    k *= 2
                steps_per_dispatch = k
        K = int(steps_per_dispatch)
        loop_fn, args, names = build_fit_loop(
            self.model, self.toas, max_iter=K, min_lambda=min_lambda,
            required_chi2_decrease=required_chi2_decrease,
            **self.step_flags)
        body = args[2:-1]   # args[-1] is the default budget
        dev = args[0].device
        noff = 1 if names and names[0] == "Offset" else 0
        th0 = args[0].cpu().numpy()
        tl0 = args[1].cpu().numpy()
        th, tl = th0.copy(), tl0.copy()
        sup = get_supervisor()
        key = "gls.fit_loop" if K > 1 else "gls.fit_step"

        def on_device(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        from pint_tpu_torch.obs import health as _health

        def observe(out):
            """The health tap of one loop call: its accepted state's
            vector when armed, and its returned host scalars either way,
            observed BEFORE the non-finite guard so an injected-NaN
            readback is an incident and the failover is unchanged."""
            hsig = {"values": [out[2], out[4]], "chi2": float(out[4]),
                    "chi2_prev": float(out[5])}
            if len(out) > 11:
                hsig["hv"] = out[11]
            _health.observe("fit.device", hsig, key=key)

        def run(th_, tl_, budget_, entry_):
            """One call of the loop on the device: (th, tl) and the
            entry step placed inside the dispatch (a guarded dispatch
            hands back host tensors)."""
            ent = None if entry_ is None else \
                tuple(on_device(x) for x in entry_)
            return loop_fn(on_device(th_), on_device(tl_), *body,
                           budget_, entry=ent)

        iterations = nevals = 0
        converged = maxed_out = False
        budget = min(K, maxiter)
        handle = None
        out = sup.dispatch(run, th, tl, budget, None, key=key,
                           steps=budget, device=dev)
        while True:
            if handle is not None:
                out = handle.result()
                handle = None
            observe(out)
            dp = out[2].cpu().numpy()
            best = float(out[4])
            if iterations == 0 and (not np.isfinite(float(out[5]))
                                    or not np.all(np.isfinite(dp))):
                raise NonFiniteStepError(
                    "device fit step produced non-finite values (singular "
                    "system? use GLSFitter's SVD fallback)")
            niter, done = int(out[6]), bool(out[7])
            nevals += int(out[10])
            deltas = out[8].cpu().numpy()
            lams = out[9].cpu().numpy()
            will_continue = not done and iterations + niter < maxiter
            if will_continue:
                budget = min(K, maxiter - iterations - niter)
                if pipeline:
                    # issue the next call NOW from the device-advanced
                    # (th', tl'), bitwise the host replay below (the
                    # loop's dd two-sum mirrors dd_np.add), so the
                    # replay overlaps it
                    handle = sup.dispatch_async(
                        run, out[0], out[1], budget,
                        out[2:5] + tuple(out[11:]), key=key,
                        steps=budget, device=dev)
            # exact host replay of the accepted updates
            for k in range(niter):
                if lams[k] > 0.0:
                    th, tl = _bump(th, tl, deltas[k])
            iterations += niter
            if done:
                converged = True
                break
            if iterations >= maxiter:
                maxed_out = True
                break
            if handle is None:
                out = sup.dispatch(run, th, tl, budget,
                                   out[2:5] + tuple(out[11:]), key=key,
                                   steps=budget, device=dev)
        cov = out[3].cpu().numpy()
        self.step_evals = nevals
        # the model goes to the accepted point even when about to raise:
        # a caller catching MaxiterReached gets the best point found
        _sync_model(self, th, tl, th0, tl0, names, noff)
        self.set_uncertainties(cov, names)
        # degeneracy check: at a genuine optimum the last proposed
        # correction is ~1 sigma of its own uncertainty or less; a huge
        # (or non-finite) one at convergence means the Cholesky-only step
        # gave a non-descent direction, as a (near-)singular design does
        with np.errstate(invalid="ignore", divide="ignore"):
            sig_steps = np.abs(dp) / np.sqrt(np.abs(np.diagonal(cov)))
        bad = bool(sig_steps.size) and not np.all(np.isfinite(sig_steps))
        finite = sig_steps[np.isfinite(sig_steps)]
        worst = float(finite.max()) if finite.size else 0.0
        if converged and (bad or worst > 1e3):
            warnings.warn(
                f"device downhill converged but the last proposed "
                f"correction is "
                f"{'non-finite' if bad else f'{worst:.1e} sigma'} — the "
                f"system is likely singular/degenerate (collinear design "
                f"columns?); prefer GLSFitter/DownhillGLSFitter (SVD "
                f"fallback) for this model", RuntimeWarning, stacklevel=3)
        # final host refresh at the optimum: residuals and the ML noise
        # realization (the step returns neither the basis amplitudes nor
        # the DM residuals)
        if self.wideband:
            from pint_tpu_torch.wideband_fitter import WidebandTOAFitter

            helper = WidebandTOAFitter(self.toas, self.model,
                                       track_mode=self.track_mode)
            _, _, _, noise, _ = helper._solve_once()
            self.noise_resids = noise
            self.resids = helper.resids
            self.dm_resids = helper.dm_resids
        else:
            _, _, _, noise, _ = self._solve_once()
            self.noise_resids = noise
        self.converged = converged
        self._record_stats(best, iterations, t0)
        if maxed_out:
            raise MaxiterReached(
                f"no convergence in {maxiter} device downhill iterations "
                f"(model left at the best point found)")
        return best
