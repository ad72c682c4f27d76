"""Per-pulsar cached accumulated normal equations + the append rank
update: the serve-side half of the matrix-free streaming GLS (a port of
pint_tpu/serve/append.py).

The online-timing workload: live telescopes stream TOAs into a
persistent per-pulsar fit state. A cold build accumulates the full
dataset once; every subsequent ``AppendTOAsRequest`` ships ONLY the new
rows — assembled at admission in O(new TOAs), with the noise basis
evaluated on the COLD span's Fourier frequencies (the ``tspan``
override) so its columns align with the cached Gram — and the device
work is a rank UPDATE of the small (p+q)^2 accumulated system plus the
preconditioned-CG finalize the streaming fitter uses, batched over the
slots of a batch (``parallel.streaming._cg_schur_batch``, the slot-axis
form of ``_cg_schur``). Re-convergence is O(new TOAs) host work +
O((p+q)^2) device work, never a cold refit.

Concurrency contract: the append program is PURE — it returns the new
rows' DELTA contributions, and the engine applies them to the store
under a lock at collect time. Deltas are additive because the column
scale ``cm`` is FROZEN at cold build (appended rows reuse it), so two
same-key requests batched together each see the pre-batch state and
both deltas land — each response reflects the data up to and including
its own rows.

States are in-memory (the store is not journaled): after a process
restart the first request per key must be a cold build
(``StateMissing`` otherwise — a replayed append must never masquerade
as a full fit). The host pieces (``build_append_rows``, the store,
``append_slot_np``) are copies of the reference's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pint_tpu_torch.parallel.pta import PulsarProblem
from pint_tpu_torch.parallel.streaming import _cg_schur_batch, \
    cg_solve_np
from pint_tpu_torch.runtime import locks

__all__ = ["AppendProblem", "AppendStore", "AppendStateEntry",
           "build_append_rows", "append_slot_np"]


class AppendProblem(PulsarProblem):
    """One append batch's assembled rows: like ``PulsarProblem`` but
    ``r`` is NOT mean-subtracted (the mean correction is applied at
    solve time from accumulated scalars, over the COMBINED set) and
    the basis span / mean-subtraction flag ride along."""

    def __init__(self, *a, tspan: float = 0.0, tref: float = 0.0,
                 submean: bool = True, **kw):
        super().__init__(*a, **kw)
        self.tspan = float(tspan)
        self.tref = float(tref)     # cold first-TOA day (basis epoch)
        self.submean = bool(submean)


def build_append_rows(toas, model, tspan: Optional[float] = None,
                      tref: Optional[float] = None,
                      track_mode=None) -> AppendProblem:
    """Assemble ONE batch of rows for the append path (O(batch) host
    work). ``tspan``/``tref`` pin the Fourier fundamental and the
    basis epoch to the cold build's (None = derive from these TOAs —
    the cold build). Rejects wideband TOAs and ECORR models
    (appended epochs would grow the basis rank past the fixed shape
    class)."""
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.wideband import has_wideband_dm

    if has_wideband_dm(toas):
        raise ValueError("AppendTOAsRequest cannot serve wideband "
                         "TOAs (no stacked [time; DM] append system)")
    pairs = model.noise_model_basis_weight_pairs(toas, tspan=tspan,
                                                 tref_day=tref)
    if any("Ecorr" in name for name, _, _ in pairs):
        raise ValueError(
            "AppendTOAsRequest cannot serve ECORR models: appended "
            "epochs grow the quantization-basis rank, which would "
            "break the cached accumulated system's fixed shape; use "
            "the streaming fitter (cold) for ECORR models")
    res = Residuals(toas, model, track_mode=track_mode,
                    subtract_mean=False)
    M, names, _ = model.designmatrix(toas, incoffset=True)
    nvec = model.scaled_toa_uncertainty(toas) ** 2
    if pairs:
        F = np.concatenate([f for _, f, _ in pairs], axis=1)
        phi = np.concatenate([p for _, _, p in pairs])
    else:
        F = np.zeros((toas.ntoas, 0))
        phi = np.ones(0)
    if tspan is None:
        from pint_tpu_torch.models.noise import _tdb_seconds

        t = _tdb_seconds(toas)
        tspan = float(t.max() - t.min()) if len(t) > 1 else 1.0
    if tref is None:
        tref = float(toas.tdb_day.min())
    return AppendProblem(
        M.cpu().numpy(), res.time_resids.cpu().numpy(), nvec, F, phi,
        names, model=model, toas=toas, tspan=tspan, tref=tref,
        submean="PhaseOffset" not in model.components)


# ------------------------------------------------------------- program


def _append_slot(cm, Sig, b, u, scal, M, F, phi, r0, nvec, valid,
                 pvalid, submean, cold, budget: int, tol: float):
    """The padded slots' rank update + re-solve, batched over the
    leading slot axis (every argument but ``budget``/``tol`` (P, ...)):
    fold the new rows' Gram/moment contributions into each slot's
    accumulated state, then CG-solve the COMBINED system via the
    Jacobi-preconditioned Schur operator the streaming fitter uses.
    Returns the DELTAS (additive; the engine owns the store mutation)
    plus the solve outputs, each (P, ...). ``cold`` slots derive their
    frozen column scale from their own rows; warm slots reuse the
    state's. ``submean``/``cold`` are per-slot flags, so PHOFF and
    cold/warm requests share one class."""
    p = M.shape[-1]
    q = F.shape[-1]
    Mm = M * pvalid[..., None, :]
    w = valid / nvec
    if M.shape[-2]:
        colmax = torch.amax(torch.abs(Mm) * valid[..., :, None], dim=-2)
    else:
        colmax = torch.zeros_like(cm)
    cm_used = torch.where(
        (cold > 0.5)[..., None],
        torch.where(colmax == 0, torch.ones_like(colmax), colmax), cm)
    cm_used = torch.where(cm_used == 0, torch.ones_like(cm_used), cm_used)
    big = torch.cat([Mm / cm_used[..., None, :],
                     F * valid[..., :, None]], dim=-1)
    bigw = big * w[..., :, None]
    dSig = big.mT @ bigw
    db = (bigw.mT @ r0[..., None])[..., 0]
    du = (bigw.mT @ valid[..., None])[..., 0]
    dscal = torch.cat([torch.stack([torch.sum(w * r0 * r0, dim=-1),
                                    torch.sum(w * r0, dim=-1),
                                    torch.sum(w, dim=-1)], dim=-1),
                       torch.zeros_like(scal[..., 3:])], dim=-1)
    Sig2 = Sig + dSig
    b2 = b + db
    u2 = u + du
    scal2 = scal + dscal
    sw = scal2[..., 2]
    swr0 = scal2[..., 1]
    mu = submean * swr0 / torch.where(sw > 0, sw, torch.ones_like(sw))
    bfin = b2 - mu[..., None] * u2
    rCr = scal2[..., 0] - 2.0 * mu * swr0 + mu * mu * sw
    zp = torch.zeros_like(pvalid)
    prior = torch.cat([zp, 1.0 / phi], dim=-1) if q else zp
    Sigma = Sig2 + torch.diag_embed(prior)
    colvalid = torch.cat([pvalid, torch.ones_like(phi)], dim=-1)
    Sigma = Sigma * (colvalid[..., :, None] * colvalid[..., None, :]) \
        + torch.diag_embed(1.0 - colvalid)
    bfin = bfin * colvalid
    dp, cov, chi2, chi2r, _, ok, iters, _resid = _cg_schur_batch(
        Sigma, bfin, rCr, cm_used, budget, tol)
    return (cm_used, dSig, db, du, dscal, dp * pvalid, cov, chi2,
            chi2r, ok, iters)


def append_slot_np(cm, Sig, b, u, scal, M, F, phi, r0, nvec, valid,
                   pvalid, submean, cold, budget=None, tol=1e-13):
    """Numpy mirror of ``_append_slot`` — the capacity router's host
    pool and the supervisor's failover path (identical algebra)."""
    p = M.shape[1]
    Mm = M * pvalid[None, :]
    w = valid / nvec
    colmax = np.max(np.abs(Mm) * valid[:, None], axis=0) \
        if M.shape[0] else np.zeros(p)
    cm_used = np.where(cold > 0.5,
                       np.where(colmax == 0, 1.0, colmax), cm)
    cm_used = np.where(cm_used == 0, 1.0, cm_used)
    big = np.concatenate([Mm / cm_used[None, :],
                          F * valid[:, None]], axis=1)
    bigw = big * w[:, None]
    dSig = big.T @ bigw
    db = bigw.T @ r0
    du = bigw.T @ valid
    dscal = np.zeros_like(scal)
    dscal[0] = np.sum(w * r0 * r0)
    dscal[1] = np.sum(w * r0)
    dscal[2] = np.sum(w)
    Sig2 = Sig + dSig
    b2 = b + db
    u2 = u + du
    scal2 = scal + dscal
    sw, swr0 = scal2[2], scal2[1]
    mu = float(submean) * swr0 / (sw if sw > 0 else 1.0)
    bfin = b2 - mu * u2
    rCr = scal2[0] - 2.0 * mu * swr0 + mu * mu * sw
    q = F.shape[1]
    prior = np.concatenate([np.zeros(p), 1.0 / phi]) if q else \
        np.zeros(p)
    Sigma = Sig2 + np.diag(prior)
    colvalid = np.concatenate([pvalid, np.ones(q)])
    Sigma = Sigma * np.outer(colvalid, colvalid) + \
        np.diag(1.0 - colvalid)
    bfin = bfin * colvalid
    dp, cov, chi2, chi2r, _, ok, iters, _resid = cg_solve_np(
        Sigma, bfin, float(rCr), cm_used, budget=budget, tol=tol)
    return (cm_used, dSig, db, du, dscal, dp * pvalid, cov, chi2,
            chi2r, ok, iters)


# ------------------------------------------------------------ store


class AppendStateEntry:
    """One pulsar's accumulated normal equations at its linearization
    point theta_0, padded to its shape class's (pb, qb). All arrays
    host numpy; mutation only through ``AppendStore.commit``."""

    __slots__ = ("key", "names", "p", "q", "pb", "qb", "cm", "Sig",
                 "b", "u", "scal", "phi", "tspan", "tref", "submean",
                 "ntoa", "updates")

    def __init__(self, key: str, names: List[str], p: int, q: int,
                 pb: int, qb: int, phi: np.ndarray, tspan: float,
                 tref: float, submean: bool):
        P = pb + qb
        self.key = key
        self.names = list(names)
        self.p = p
        self.q = q
        self.pb = pb
        self.qb = qb
        self.cm = np.ones(pb)
        self.Sig = np.zeros((P, P))
        self.b = np.zeros(P)
        self.u = np.zeros(P)
        self.scal = np.zeros(8)
        self.phi = np.asarray(phi, np.float64)
        self.tspan = float(tspan)
        self.tref = float(tref)
        self.submean = bool(submean)
        self.ntoa = 0
        self.updates = 0

    def check_compatible(self, problem):
        from pint_tpu_torch.serve.bucket import pad_dim

        if list(problem.names) != self.names:
            raise ValueError(
                f"append state {self.key!r} was built for params "
                f"{self.names}; this request's model has "
                f"{list(problem.names)} — re-submit a cold build")
        if pad_dim(problem.M.shape[1]) != self.pb or \
                pad_dim(problem.F.shape[1]) != self.qb:
            raise ValueError(
                f"append state {self.key!r} shape class changed; "
                f"re-submit a cold build")
        if problem.phi.shape[0] != self.q or (
                self.q and not np.allclose(problem.phi,
                                           self.phi[:self.q])):
            raise ValueError(
                f"append state {self.key!r}: noise hyperparameters "
                f"changed since the cold build — re-linearize with a "
                f"cold build")

    def stacked_phi(self) -> np.ndarray:
        out = np.ones(self.qb)
        out[:self.q] = self.phi[:self.q]
        return out


class AppendStore:
    """The engine's per-pulsar state registry. Reads at dispatch
    time, delta commits at collect time, both under one lock; the
    counters are registry-backed."""

    def __init__(self):
        import weakref

        from pint_tpu_torch.obs import metrics as om

        self._lock = locks.make_lock("serve.append_store")
        self._states: dict = {}
        scope = om.new_scope("append")
        self._c_cold = om.counter(
            "pint_tpu_append_cold_builds_total",
            "append-state cold builds").child(scope=scope)
        self._c_upd = om.counter(
            "pint_tpu_append_rank_updates_total",
            "append-state rank updates").child(scope=scope)
        # weakref pull-fn (the bucket.py gauge pattern): the registry
        # is process-global and outlives the engine — a strong `self`
        # capture would pin every per-pulsar (P,P) state past
        # shutdown; a dead store's gauge just stops producing
        ref = weakref.ref(self)
        om.gauge("pint_tpu_append_states",
                 "live per-pulsar append states").set_fn(
            lambda: (lambda s: float(len(s._states))
                     if s is not None else None)(ref()),
            scope=scope)

    def get(self, key: str) -> Optional[AppendStateEntry]:
        with self._lock:
            return self._states.get(key)

    def commit(self, key: str, problem, pb: int, qb: int, cold: bool,
               cm_used, dSig, db, du, dscal, nrows: int
               ) -> AppendStateEntry:
        """Apply one slot's deltas. A cold commit (RE)CREATES the
        entry from zero — that is the explicit re-linearization path
        (changed parameters/hyperparameters, or a fresh dataset);
        the previous state, if any, is replaced wholesale. Two cold
        builds racing in one batch therefore resolve last-wins —
        each is a complete dataset by the explicit-cold contract, so
        either outcome is internally consistent."""
        with self._lock:
            entry = self._states.get(key)
            if cold:
                entry = AppendStateEntry(
                    key, problem.names, problem.M.shape[1],
                    problem.F.shape[1], pb, qb, problem.phi,
                    problem.tspan, problem.tref, problem.submean)
                entry.cm = np.asarray(cm_used, np.float64).copy()
                self._states[key] = entry
                self._c_cold.inc()
            else:
                if entry is None:
                    from pint_tpu_torch.serve.request import StateMissing

                    raise StateMissing(
                        f"append state {key!r} vanished before "
                        f"collect (restart?)")
                self._c_upd.inc()
            entry.Sig += np.asarray(dSig)
            entry.b += np.asarray(db)
            entry.u += np.asarray(du)
            entry.scal += np.asarray(dscal)
            entry.ntoa += int(nrows)
            entry.updates += 1
            return entry

    def drop(self, key: str):
        with self._lock:
            self._states.pop(key, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "states": len(self._states),
                "cold_builds": int(self._c_cold.value()),
                "rank_updates": int(self._c_upd.value()),
                "ntoa_total": int(sum(e.ntoa
                                      for e in self._states.values())),
            }


def append_kernel():
    """The batched slot program (one function serves every class)."""
    return _append_slot
