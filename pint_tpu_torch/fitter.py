"""Fitters: weighted least squares (WLS), the downhill wrapper, and
``Fitter.auto`` (a port of pint_tpu/fitter.py; reference:
src/pint/fitter.py Fitter, WLSFitter, DownhillFitter family).

Residuals, the design matrix and the solve stay on the model's device
as float64 tensors; the host keeps the parameter bookkeeping (exact dd
parameter values, updated by add_delta) and the accept/reject logic.

Each linearized pass (residuals, design matrix and solve) is one
supervised dispatch (``runtime``, key ``wls.solve``); its host failover
rebuilds the pass on the CPU from host state and solves with the numpy
mirror ``_wls_solve_np``, so it never reads from the card.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from pint_tpu_torch.profiling import FitStats
from pint_tpu_torch.residuals import Residuals

__all__ = ["Fitter", "WLSFitter", "DownhillWLSFitter", "fit_summary",
           "FitStats", "ConvergenceFailure", "MaxiterReached",
           "StepProblem", "DegeneracyWarning", "rehome_to_cpu",
           "cpu_copy"]


class DegeneracyWarning(UserWarning):
    """The normal matrix was singular or ill-conditioned enough that the
    Cholesky solve failed and the SVD fallback (which drops
    near-degenerate directions) was used."""


def warn_degenerate(what: str = "normal matrix") -> None:
    import warnings

    warnings.warn(
        f"{what} Cholesky failed (degenerate design columns?); "
        f"using the SVD fallback", DegeneracyWarning, stacklevel=4)


class ConvergenceFailure(RuntimeError):
    pass


class MaxiterReached(ConvergenceFailure):
    pass


class StepProblem(ConvergenceFailure):
    pass


def _wls_solve(M, r, err_s, threshold=None):
    """min ||(r − Mx)/σ||²: column-normalized SVD solve, singular values
    below threshold·s_max dropped (reference: _wls_solve). Returns
    (x, cov, chi2_post_linear)."""
    w = 1.0 / err_s
    colmax = torch.amax(torch.abs(M), dim=0)
    colmax = torch.where(colmax == 0, torch.ones_like(colmax), colmax)
    Mw = (M / colmax[None, :]) * w[:, None]
    rw = r * w
    norm = torch.sqrt(torch.sum(Mw * Mw, dim=0))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    Mn = Mw / norm[None, :]
    U, s, Vt = torch.linalg.svd(Mn, full_matrices=False)
    thresh = (threshold if threshold is not None
              else float(np.finfo(np.float64).eps) * max(M.shape))
    keep = s > thresh * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    x_n = Vt.T @ (s_inv * (U.T @ rw))
    x = x_n / colmax / norm
    cov_n = (Vt.T * (s_inv ** 2)[None, :]) @ Vt
    cov = cov_n / torch.outer(colmax, colmax) / torch.outer(norm, norm)
    resid_post = rw - Mn @ x_n
    return x, cov, torch.sum(resid_post ** 2)


def _wls_solve_np(M, r, err_s, threshold=None):
    """Pure-numpy mirror of _wls_solve — the supervised dispatch's
    host-failover path (identical two-stage scaling + thresholded SVD;
    a copy of the reference's)."""
    w = 1.0 / err_s
    colmax = np.max(np.abs(M), axis=0)
    colmax[colmax == 0] = 1.0
    Mw = (M / colmax[None, :]) * w[:, None]
    rw = r * w
    norm = np.sqrt(np.sum(Mw * Mw, axis=0))
    norm[norm == 0] = 1.0
    Mn = Mw / norm[None, :]
    U, s, Vt = np.linalg.svd(Mn, full_matrices=False)
    thresh = (threshold if threshold is not None
              else np.finfo(np.float64).eps * max(M.shape))
    keep = s > thresh * s[0]
    with np.errstate(divide="ignore"):
        s_inv = np.where(keep, 1.0 / np.where(s == 0, 1.0, s), 0.0)
    x_n = Vt.T @ (s_inv * (U.T @ rw))
    x = x_n / colmax / norm
    cov_n = (Vt.T * (s_inv ** 2)[None, :]) @ Vt
    cov = cov_n / np.outer(colmax, colmax) / np.outer(norm, norm)
    resid_post = rw - Mn @ x_n
    return x, cov, float(np.sum(resid_post ** 2))


def rehome_to_cpu(model, cause, what: str = "device fit") -> bool:
    """Move ``model`` to the CPU after its device failed a fit: set its
    device and drop every per-device cache, with a labelled
    RuntimeWarning. Nothing is read from the old device (the caches
    are rebuilt from host state). Returns False when the model is on
    the CPU already."""
    if model.device.type == "cpu":
        return False
    warnings.warn(
        f"{what} unavailable on {model.device} ({type(cause).__name__}: "
        f"{cause}); the model moves to the CPU", RuntimeWarning,
        stacklevel=3)
    model.device = torch.device("cpu")
    model.invalidate_cache()
    return True


def cpu_copy(model):
    """A deep copy of ``model`` on the CPU made from host state only: the
    per-device caches are left behind, never read from the card."""
    from pint_tpu_torch.models.timing_model import copy_model

    out = copy_model(model)
    out.device = torch.device("cpu")
    return out


class Fitter:
    """Base fitter: parameter bookkeeping + the fit_toas contract
    (reference: Fitter). Runs on the model's device."""

    def __init__(self, toas, model, residuals=None, track_mode=None):
        self.toas = toas
        self.model = model
        self.device = model.device
        self.track_mode = track_mode
        self.resids_init = residuals or Residuals(toas, model,
                                                  track_mode=track_mode)
        self.resids = self.resids_init
        self.parameter_covariance_matrix = None
        self.errors: Dict[str, float] = {}
        self.converged = False
        self.stats = None  # FitStats, set by fit_toas

    def _residuals(self, device=None) -> Residuals:
        return Residuals(self.toas, self.model, track_mode=self.track_mode,
                         device=device)

    def _errors_s(self, device=None) -> torch.Tensor:
        return torch.as_tensor(self.toas.get_errors() * 1e-6,
                               dtype=torch.float64,
                               device=self.device if device is None
                               else device)

    def _solve_scope(self):
        """Context manager scoping a pinned solve: the CPU as torch's
        default device when ``config.solve_device`` pins this problem
        ($PINT_TPU_HOST_SOLVE_MAX_TOA), else a no-op."""
        from pint_tpu_torch.config import solve_scope

        return solve_scope(self.toas.ntoas, self.device)

    def _solve_pinned(self) -> bool:
        """True when this problem's solves are pinned to the CPU."""
        from pint_tpu_torch.config import solve_device

        return solve_device(self.toas.ntoas, self.device) is not None

    def _pass_device(self) -> torch.device:
        """The device a supervised linearized pass runs on."""
        return torch.device("cpu") if self._solve_pinned() else self.device

    def _after_failover(self, key: str, cause) -> None:
        """Count and label a per-solve host failover. When the device's
        breaker is open (or latched after a lost context) the rest of
        the fit cannot use the card either — its residual passes run on
        the model's device — so the model moves to the CPU."""
        from pint_tpu_torch.runtime import backend_of, breaker_for, \
            get_supervisor

        get_supervisor().note_failover(key, cause)
        if self.device.type != "cpu" and \
                breaker_for(backend_of(self.device)).is_open:
            self._rehome(cause)

    def _rehome(self, cause) -> None:
        """Move the model, and this fitter, to the CPU."""
        rehome_to_cpu(self.model, cause, f"{type(self).__name__}")
        self.device = self.model.device

    def _wls_dispatch(self, threshold):
        """One linearized WLS pass — residuals, design matrix and the
        ``_wls_solve`` — as a supervised dispatch on the pass's device
        (key ``wls.solve``; reference: _wls_dispatch). Its host failover
        rebuilds the pass on the CPU and solves with ``_wls_solve_np``.
        Returns (correction (p,), cov (p, p), names, residuals)."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import DispatchError, get_supervisor

        dev = self._pass_device()

        def run():
            with self._solve_scope():
                res = self._residuals(dev)
                M, names, _ = self.model.designmatrix(
                    self.toas, incoffset=True, device=dev)
                x, cov, _ = _wls_solve(M, res.time_resids,
                                       self._errors_s(dev), threshold)
                # r ≈ M·(θ−θ_true): the parameter correction is −x
                return -x, cov, names, res

        def host():
            res = self._residuals("cpu")
            M, names, _ = self.model.designmatrix(
                self.toas, incoffset=True, device="cpu")
            x, cov, _ = _wls_solve_np(
                M.numpy(), res.time_resids.numpy(),
                self.toas.get_errors() * 1e-6, threshold)
            return torch.from_numpy(-x), torch.from_numpy(cov), names, res

        with obs.span("wls.solve", ntoa=self.toas.ntoas):
            try:
                x, cov, names, res = get_supervisor().dispatch(
                    run, key="wls.solve", device=dev,
                    pinned=self._solve_pinned())
            except DispatchError as e:
                self._after_failover("wls.solve", e)
                x, cov, names, res = host()
        return x.cpu().numpy(), cov.cpu().numpy(), names, res

    def _dof(self) -> int:
        """Degrees of freedom of the fit's chi2."""
        return getattr(self.resids, "dof",
                       self.toas.ntoas - len(self.model.free_params))

    def _record_stats(self, chi2: float, iterations: int, t0: float):
        wall = time.perf_counter() - t0
        n = self.toas.ntoas
        dof = self._dof()
        self.stats = FitStats(
            fitter=type(self).__name__, ntoa=n,
            nfree=len(self.model.free_params), dof=dof,
            chi2=float(chi2),
            reduced_chi2=float(chi2) / dof if dof else float("nan"),
            iterations=iterations, converged=self.converged,
            wall_time_s=wall,
            toas_per_sec=n * max(1, iterations) / wall if wall else 0.0)
        return self.stats

    @staticmethod
    def auto(toas, model, downhill=True, device=None, serve=None,
             streaming=None, **kw):
        """Pick a fitter from model contents and data (reference:
        Fitter.auto): the wideband fitters when the TOAs carry -pp_dm DM
        channels, GLS when correlated-noise components are present, WLS
        otherwise; downhill wrappers by default.

        ``streaming`` picks the matrix-free ``StreamingGLSFitter``
        (chunked normal equations and preconditioned CG, peak device
        memory O(chunk + (p+q)^2)). Default: on for narrowband downhill
        fits of at least ``config.solve_streaming()`` TOAs
        ($PINT_TPU_STREAM_MIN_TOA, default 200,000; 0 turns it off)
        unless ``device=True``; True or False overrides. Wideband TOAs
        on this route raise ValueError.

        ``device=True`` picks ``DeviceDownhillGLSFitter``: each downhill
        trial is one fit step on the model's device (wideband TOAs get
        the stacked step); it requires ``downhill``. ``device=None``
        means False: the reference turns it on only on a TPU backend.
        Pass ``whole_fit=``/``pipeline=`` through ``kw``.

        While the circuit breaker of the model's device is open (the
        card timed out or failed repeatedly, or lost its context), the
        model moves to the CPU first, with a labelled RuntimeWarning, and
        the fitter picked runs there (reference: the breaker check of
        Fitter.auto).

        ``serve=engine`` returns a ``ServeGLSFitter``: each iteration's
        solve is one ``FitStepRequest`` coalesced with whatever else the
        ``serve.ServeEngine`` is serving. It excludes ``device=True``
        and refuses wideband TOAs (ValueError): the batched serve solve
        has no stacked [time; DM] system."""
        from pint_tpu_torch.config import solve_streaming
        from pint_tpu_torch.runtime import BackendUnavailable, \
            backend_of, breaker_for
        from pint_tpu_torch.wideband import has_wideband_dm

        wideband = has_wideband_dm(toas)
        if serve is not None:
            if device:
                raise ValueError(
                    "serve= and device=True are exclusive: the serve "
                    "path batches solves across requests, the device "
                    "path chains iterations within one request")
            if wideband:
                raise ValueError(
                    "serve= cannot fit wideband TOAs: the batched "
                    "serve solve has no [time; DM] stacked system — "
                    "dropping the DM channels silently would corrupt "
                    "the fit. Use Fitter.auto without serve=")
            from pint_tpu_torch.serve import ServeGLSFitter

            return ServeGLSFitter(toas, model, engine=serve, **kw)
        backend = backend_of(model.device)
        if backend != "cpu" and breaker_for(backend).is_open:
            rehome_to_cpu(model, BackendUnavailable(
                f"the {backend} circuit breaker is open"), "Fitter.auto")
        if streaming is None:
            thresh = solve_streaming()
            streaming = (downhill and not wideband and device is not True
                         and thresh > 0 and toas.ntoas >= thresh)
        if streaming:
            if wideband:
                raise ValueError(
                    "streaming=True cannot fit wideband TOAs (the "
                    "streaming accumulator has no stacked [time; DM] "
                    "system); use the dense wideband fitters")
            from pint_tpu_torch.gls import StreamingGLSFitter

            return StreamingGLSFitter(toas, model, **kw)
        if device and not downhill:
            raise ValueError(
                "device=True requires downhill=True: the device fit "
                "path IS a downhill loop (use build_fit_step directly "
                "for single linearized solves)")
        if device:
            from pint_tpu_torch.gls import DeviceDownhillGLSFitter

            return DeviceDownhillGLSFitter(toas, model, wideband=wideband,
                                           **kw)
        if wideband:
            from pint_tpu_torch.wideband_fitter import (
                WidebandDownhillFitter,
                WidebandTOAFitter,
            )

            cls = WidebandDownhillFitter if downhill else WidebandTOAFitter
        elif model.has_correlated_errors:
            from pint_tpu_torch.gls import DownhillGLSFitter, GLSFitter

            cls = DownhillGLSFitter if downhill else GLSFitter
        else:
            cls = DownhillWLSFitter if downhill else WLSFitter
        return cls(toas, model, **kw)

    # -- shared plumbing ----------------------------------------------

    def get_fitparams(self) -> List[str]:
        return self.model.free_params

    def get_designmatrix(self):
        return self.model.designmatrix(self.toas, incoffset=True)

    def update_model(self, x, names: List[str]):
        for name, dx in zip(names, np.asarray(x, np.float64)):
            if name == "Offset":
                continue
            self.model.get_param(name).add_delta(float(dx))
        self.model.invalidate_cache(params_only=True)

    def set_uncertainties(self, cov, names: List[str]):
        cov = np.asarray(cov, np.float64)
        self.parameter_covariance_matrix = cov
        sig = np.sqrt(np.diag(cov))
        for name, s in zip(names, sig):
            if name == "Offset":
                continue
            self.model.get_param(name).uncertainty = float(s)
            self.errors[name] = float(s)

    def print_summary(self):
        print(fit_summary(self))

    def fit_toas(self, maxiter=1, **kw):
        raise NotImplementedError


class WLSFitter(Fitter):
    """Weighted least squares via SVD (reference: WLSFitter)."""

    def _solve(self, threshold):
        x, cov, names, self.resids = self._wls_dispatch(threshold)
        return x, cov, names

    def fit_toas(self, maxiter=1, threshold=None):
        t0 = time.perf_counter()
        for _ in range(max(1, maxiter)):
            x, cov, names = self._solve(threshold)
            self.update_model(x, names)
            self.set_uncertainties(cov, names)
        self.resids = self._residuals()
        chi2 = self.resids.chi2
        self.converged = True
        self._record_stats(chi2, max(1, maxiter), t0)
        return chi2


class DownhillWLSFitter(WLSFitter):
    """Step-halving line search (reference: DownhillWLSFitter): accept a
    step only if chi2 improves, else retry with lambda/2; raise after
    exhausting maxiter."""

    def fit_toas(self, maxiter=20, threshold=None, min_lambda=1e-3,
                 required_chi2_decrease=1e-2):
        t0 = time.perf_counter()
        iterations = 0
        best_chi2 = self._residuals().chi2
        converged = False
        for _ in range(maxiter):
            iterations += 1
            x, cov, names = self._solve(threshold)
            lam, accepted = 1.0, False
            while lam >= min_lambda:
                self.update_model(lam * x, names)
                new_chi2 = self._residuals().chi2
                if new_chi2 <= best_chi2 + 1e-12:
                    accepted = True
                    break
                self.update_model(-lam * x, names)  # undo
                lam /= 2.0
            if not accepted:
                converged = True  # cannot improve: at the minimum
                break
            improved = best_chi2 - new_chi2
            best_chi2 = new_chi2
            self.set_uncertainties(cov, names)
            if improved < required_chi2_decrease:
                converged = True
                break
        else:
            raise MaxiterReached(
                f"no convergence in {maxiter} downhill iterations")
        self.converged = converged
        self.resids = self._residuals()
        if self.parameter_covariance_matrix is None:
            self.set_uncertainties(cov, names)
        self._record_stats(best_chi2, iterations, t0)
        return best_chi2


def fit_summary(fitter: Fitter) -> str:
    """Human-readable post-fit report (reference: Fitter.print_summary)."""
    m = fitter.model
    res = fitter.resids
    lines = [
        f"Fitted model {m.name or '?'} with {type(fitter).__name__}",
        f"TOAs: {fitter.toas.ntoas}   free params: "
        f"{len(m.free_params)}   dof: {res.dof}",
        f"Post-fit weighted RMS: {res.rms_weighted() * 1e6:.4f} us",
        f"chi2: {res.chi2:.3f}   reduced chi2: {res.reduced_chi2:.4f}",
        "",
        f"{'PARAM':<12} {'VALUE':>24} {'UNCERTAINTY':>14} UNITS",
    ]
    for name in m.free_params:
        p = m.get_param(name)
        lines.append(f"{name:<12} {p._format_value():>24} "
                     f"{p._format_uncertainty():>14} {p.units}")
    return "\n".join(lines)
