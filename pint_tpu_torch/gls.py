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
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from pint_tpu_torch.fitter import Fitter, MaxiterReached, warn_degenerate
from pint_tpu_torch.residuals import Residuals

__all__ = ["GLSFitter", "DownhillGLSFitter", "gls_chi2"]


def equilibrate(M, w):
    """(Mn, colmax, norm): the reference's two-stage column scaling —
    by the column max (keeps sum(M^2 w) in range for the ~1e13 s/unit
    spin columns), then to unit weighted norm."""
    colmax = torch.amax(torch.abs(M), dim=0)
    colmax = torch.where(colmax == 0, torch.ones_like(colmax), colmax)
    Ms = M / colmax[None, :]
    norm = torch.sqrt(torch.sum(Ms * Ms * w[:, None], dim=0))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return Ms / norm[None, :], colmax, norm


def jacobi(S):
    """sqrt of the diagonal, 1 where it is zero or not finite: the
    unit-diagonal preconditioner of every Cholesky here."""
    d = torch.sqrt(torch.diagonal(S))
    return torch.where((d == 0) | ~torch.isfinite(d), torch.ones_like(d), d)


def cho_factor(A):
    """Lower Cholesky factor; all NaN when A is not positive definite
    (jax.scipy.linalg.cho_factor's behaviour, without a host sync)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def cho_solve(L, b):
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.cholesky_solve(b, L)


def _gls_kernel(M, F, phi, r, nvec):
    """Basis-Woodbury GLS solve. Returns (dparams, cov_pp, chi2,
    noise_resid, xhat_full, ok) — ok False when the Cholesky failed or
    its solve does not check out (callers then use the eigh solve)."""
    p = M.shape[1]
    w = 1.0 / nvec
    Mn, colmax, norm = equilibrate(M, w)
    big = torch.cat([Mn, F], dim=1)
    sw = torch.sqrt(w)
    bigs = big * sw[:, None]
    Sigma = bigs.T @ bigs
    prior = torch.cat([torch.zeros(p, dtype=M.dtype, device=M.device),
                       1.0 / phi])
    Sigma = Sigma + torch.diag(prior)
    b = (bigs.T @ (r * sw)[:, None])[:, 0]
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
    return dparams, cov, chi2, noise_resid, xhat, ok


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


def gls_chi2(model, toas, resids=None, device=None) -> float:
    """GLS chi2 of current residuals (basis-marginalized), on ``device``
    (the model's by default)."""
    dev = model.device if device is None else device
    r = resids if resids is not None else \
        Residuals(toas, model, device=dev).time_resids
    nvec, F, phi = model.noise_device(toas, r.device)
    if F.shape[1] == 0:
        return float(torch.sum(r ** 2 / nvec))
    return float(_gls_chi2_kernel(F, phi, r, nvec))


class GLSFitter(Fitter):
    """GLS fit with correlated noise marginalized in basis space
    (reference: GLSFitter); with ``full_cov`` every solve uses the dense
    N x N covariance instead."""

    def __init__(self, toas, model, residuals=None, track_mode=None,
                 full_cov=False):
        super().__init__(toas, model, residuals=residuals,
                         track_mode=track_mode)
        self.full_cov = full_cov
        self.noise_resids: Optional[torch.Tensor] = None

    def _system(self):
        """(M, r, nvec, F, phi, names) of the linearized problem at the
        current parameters, float64 tensors on the model's device."""
        self.resids = self._residuals()
        M, names, _ = self.get_designmatrix()
        nvec, Fb, phi = self.model.noise_device(self.toas, self.device)
        return M, self.resids.time_resids, nvec, Fb, phi, names

    def _solve_once(self, threshold=None):
        """One linearized solve of ``_system`` at the current parameters:
        (x, cov, chi2, noise_resid, names), x and cov as numpy for the
        host's parameter update, noise_resid the N time-channel rows."""
        M, r, nvec, Fb, phi, names = self._system()
        if self.full_cov:
            x, cov, chi2, noise = _gls_kernel_fullcov(M, Fb, phi, r, nvec)
        elif threshold is not None:
            x, cov, chi2, noise, _ = _gls_kernel_svd(
                M, Fb, phi, r, nvec, threshold=float(threshold))
        else:
            x, cov, chi2, noise, _, ok = _gls_kernel(M, Fb, phi, r, nvec)
            if not bool(ok):
                warn_degenerate()
                x, cov, chi2, noise, _ = _gls_kernel_svd(M, Fb, phi, r,
                                                         nvec)
        # r ≈ M (θ − θ_true): the correction is −x
        return ((-x).cpu().numpy(), cov.cpu().numpy(), float(chi2),
                noise[:self.toas.ntoas], names)

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

