"""One GLS/WLS fit iteration as a single function of tensors (a port of
the float64 route of pint_tpu/parallel/fit_step.py; reference:
src/pint/fitter.py GLSFitter.fit_toas).

    step_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid, jvar)
        -> (dparams, cov, chi2, resids)

runs the whole iteration on the device of its arguments: the dd phase
chain, residuals with the weighted mean removed, the design matrix
(``torch.func.jacfwd`` over the free parameters), whitening, the normal equations with the
red-noise Fourier basis and ECORR's per-epoch Sherman-Morrison
downdates, the Jacobi-scaled Cholesky and the noise-marginalized chi2.
The signature and output order are the reference's, so one function's
arguments can be fed to the other (models.convert.fit_args_from_numpy).
With ``wideband=True`` the step solves the stacked [time; DM] system of
wideband TOAs (reference: WidebandTOAFitter's joint solve): the DM
channel's residuals (-pp_dm/-pp_dme flags, DMEFAC/DMEQUAD-scaled) and
its ``jacfwd`` rows ride below the time rows, DM-process bases
(PLDMNoise) couple into them, and ``resids`` stays the N time residuals.

This is the route the reference takes on its CPU backend, where float64
is IEEE, as it is on the GPU: the direct dd phase chain, the float64
Jacobian and the float64 Gram, with the reference's hybrid Jacobian
split an option (off by default, see ``_build_fit_core``). The anchored,
f32-Jacobian and f32-Gram routes are not ported (ROADMAP.md).

``pad_to`` pads the TOA axis to a fixed length: the padded rows repeat
the last TOA (zero rows would put the observer at the SSB and give NaN
in the Shapiro log) and carry ``valid`` 0, nvec 1 and no noise basis, so
every reduction ignores them. ``health=True`` (or $PINT_TPU_HEALTH) adds
a fifth output, the health vector [nonfinite count, max |residual| in
sigma over the valid rows, chi2] (``obs.health``); without it the step
runs exactly the ops it runs when no health is asked for.

``build_fit_loop`` runs up to K downhill iterations of the step, the
step-halving line search included, and returns the ledger of applied
updates the host replays in exact dd (reference: build_fit_loop).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from pint_tpu_torch import resolve_device
from pint_tpu_torch.gls import cho_factor, cho_solve, downhill_dd, \
    equilibrate, jacobi
from pint_tpu_torch.models.timing_model import make_pv
from pint_tpu_torch.ops.dd import dd, dd_add, dd_frac

__all__ = ["build_fit_step", "build_fit_parts", "build_fit_loop",
           "SegmentSum"]


def _pad_to(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple


def _tree_map(fn, x):
    """``fn`` over the leaves of dicts and NamedTuples (ToaBatch, DD)."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    return fn(x)


def _pad_rows(a: torch.Tensor, pad: int, dim: int = 0) -> torch.Tensor:
    """``a`` with its last row along ``dim`` repeated ``pad`` times."""
    last = a.narrow(dim, a.shape[dim] - 1, 1)
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, last.expand(*shape)], dim=dim)


def _pad_leaf(a, pad: int):
    """Pad the TOA axis of a ToaBatch leaf by repeating the last row
    (zero padding would put observers at the SSB origin and NaN the
    Shapiro log; the repeated rows are real physics, masked out of every
    reduction by ``valid``). Leaves are (N,), (N, 3) or (P, N, 3);
    scalars and the TZR batch's 1-length leaves are left alone."""
    if not isinstance(a, torch.Tensor) or a.ndim == 0 or \
            tuple(a.shape) == (1,):
        return a
    return _pad_rows(a, pad, dim=1 if a.ndim == 3 else 0)


class SegmentSum:
    """Deterministic segment sums x -> (nseg, ...) over a fixed epoch-id
    vector: rows sorted by epoch once, on the host, into a padded gather
    table (every epoch but the last slot, whose padding points at a zero
    row) plus the row list of the last slot (ECORR's 'no epoch' slot,
    which may hold many TOAs). Each sum then runs in a fixed order, so
    the float64 results repeat bitwise from call to call — unlike
    ``index_add_``, whose float atomics on CUDA do not."""

    def __init__(self, eid: torch.Tensor, nseg: int):
        e = eid.cpu().numpy().astype(np.int64)
        n = e.shape[0]
        order = np.argsort(e, kind="stable")
        es = e[order]
        counts = np.bincount(e, minlength=nseg)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        width = int(counts[:-1].max()) if nseg > 1 else 0
        table = np.full((nseg - 1, max(width, 1)), n, dtype=np.int64)
        head = es < nseg - 1
        pos = np.arange(n) - starts[es]
        table[es[head], pos[head]] = order[head]
        self.table = torch.as_tensor(table, device=eid.device)
        self.last = torch.as_tensor(order[~head], device=eid.device)

    def to(self, device) -> "SegmentSum":
        """The same plan with its index tensors on ``device``."""
        out = object.__new__(SegmentSum)
        out.table, out.last = self.table.to(device), self.last.to(device)
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xz = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        head = xz[self.table].sum(dim=1)
        tail = x[self.last].sum(dim=0, keepdim=True)
        return torch.cat([head, tail])


def _build_fit_core(model, toas, device=None, hybrid_jac=False,  # graftlint: allow G14 -- the producer's builder: the step it returns computes the health vector (output 5), which the callers of the step observe
                    wideband=False, arg_device=None, pad_to=None,
                    health=None):
    """(step_fn, parts_fn, args, names, meta) on ``device`` (the model's
    by default), the TOA-axis arguments on ``arg_device`` (``device`` by
    default; the streaming accumulator keeps them on the host and
    uploads one chunk at a time). ``pad_to`` (> N) pads the TOA axis
    and ``health`` adds the health vector (module docstring; ``health``
    None reads $PINT_TPU_HEALTH). ``dparams`` is aligned with
    ``names``: an implicit
    Offset column leads unless the model has a PhaseOffset, and then
    the residuals are not mean-subtracted either (check names[0]).
    ``wideband`` stacks the DM channel's rows below the time rows
    (module docstring).

    Every design column comes from one vmapped jacfwd over all free
    parameters. ``hybrid_jac=True`` takes the reference's default
    instead: closed-form columns for the linear parameters and jacfwd
    over the rest. Eager, the closed-form columns cost a second delay
    chain and a stage-sensitivity JVP over the whole chain (main and
    TZR rows), while more tangents do not add launches (vmap), so the
    all-jacfwd step is the faster one (PERF.md)."""
    from pint_tpu_torch import config

    dev = model.device if device is None else resolve_device(device)
    adev = dev if arg_device is None else resolve_device(arg_device)
    health_on = config.health_enabled(health)
    phase_fn, (free, frozen) = model._build_phase_fn()
    cache = model.get_cache(toas, adev)
    _, _, th, tl, fh, fl = model._pack()
    f0_src = ("free", free.index("F0")) if "F0" in free \
        else ("frozen", frozen.index("F0"))
    # PHOFF replaces the implicit Offset column (both at once are
    # exactly collinear)
    incoffset = "PhaseOffset" not in model.components
    batch = cache["batch"]
    sc = {k: v for k, v in cache.items() if k != "batch"}
    n = toas.ntoas

    def tensor(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=adev)

    # per-TOA PHASE-command offsets (tim -padd flags, turns), added
    # where the host Residuals adds them
    padd_np = np.array(toas.get_flag_value("padd", 0.0, float))
    has_padd = bool(np.any(padd_np != 0.0))
    if has_padd:
        sc = {**sc, "padd": tensor(padd_np)}

    # with hybrid_jac, closed-form columns for the linear params and AD
    # tangents only for the rest (static split at build time)
    lin_set = model.linear_design_names() if hybrid_jac else set()
    nl_idx_list = [i for i, nm in enumerate(free) if nm not in lin_set]
    nl_idx = torch.as_tensor(nl_idx_list, dtype=torch.long, device=dev)

    if wideband:
        from pint_tpu_torch.wideband import get_wideband_dm

        dm_meas_np, _ = get_wideband_dm(toas)
        # DMEFAC/DMEQUAD-scaled DM sigmas, as DMResiduals has them
        sc = {**sc, "wb_dm": tensor(dm_meas_np),
              "wb_dme": tensor(model.scaled_dm_uncertainty(toas))}
        # tangents for the DM-affecting columns only: every other column
        # of the DM rows is structurally zero
        dm_set = model.dm_affecting_free_params()
        dm_idx_list = [i for i, nm in enumerate(free) if nm in dm_set]
        dm_idx = torch.as_tensor(dm_idx_list, dtype=torch.long, device=dev)

    nvec_np = model.scaled_toa_uncertainty(toas) ** 2
    # ECORR rides the Sherman-Morrison segment path (one rank-1
    # downdate per observing epoch); only the Fourier bases stay dense
    seg = model.noise_model_ecorr_segments(toas)
    if seg is not None:
        eid_np, jvar_np, exclude = seg
    else:
        eid_np, jvar_np, exclude = np.zeros(n, np.int32), np.zeros(1), ()
    F_np = model.noise_model_designmatrix(toas, exclude=exclude)
    phi_np = model.noise_model_basis_weight(toas, exclude=exclude)
    if F_np is None:
        F_np, phi_np = np.zeros((n, 0)), np.ones(0)
    nseg = len(jvar_np)
    if wideband:
        Fdm_np = model.noise_model_dm_designmatrix(toas, exclude=exclude)
        sc = {**sc, "wb_Fdm": tensor(np.zeros((n, 0)) if Fdm_np is None
                                     else Fdm_np)}

    valid_np = np.ones(n)
    if pad_to is not None and pad_to > n:
        pad = int(pad_to) - n

        def padn(x, fill=0.0):
            x = np.asarray(x)
            return np.concatenate([x, np.full((pad,) + x.shape[1:], fill,
                                              x.dtype)])

        batch = _tree_map(lambda a: _pad_leaf(a, pad), batch)
        sc = _tree_map(lambda a: _pad_rows(a, pad)
                       if isinstance(a, torch.Tensor) and a.ndim
                       and a.shape[0] == n else a, sc)
        F_np = padn(F_np)
        nvec_np = padn(nvec_np, fill=1.0)  # no 0-division; masked out
        valid_np = padn(valid_np)
        # padded rows carry w = 0, so their segment is irrelevant: the
        # zero-variance 'no epoch' slot nseg - 1
        eid_np = padn(eid_np, fill=nseg - 1)
    eid_t = tensor(eid_np, torch.long)

    def stack_eid(eid):
        """The epoch ids of the step's rows: the DM rows of a wideband
        stack ride ECORR's zero-variance 'no epoch' slot nseg - 1."""
        if not wideband:
            return eid
        return torch.cat([eid, torch.full_like(eid, nseg - 1)])

    # the segment plan of the built eid, made once here; an eid argument
    # of its own (converted arguments) gets its plan once, on first use
    plans = {"eid": eid_t,
             "plan": SegmentSum(stack_eid(eid_t), nseg) if nseg > 1
             else None}

    def segment_plan(eid):
        if nseg > 1 and eid is not plans["eid"]:
            plans["eid"], plans["plan"] = eid, SegmentSum(stack_eid(eid),
                                                          nseg)
        return plans["plan"]

    def parts_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid,
                 eid, jvar):
        """Design/residual assembly: (M, Fv, r0, nvec, valid, eid,
        tmask), r0 the masked residuals WITHOUT the weighted-mean
        subtraction."""
        def phase_f64(thx):
            ph, _ = phase_fn(thx, tl, fh, fl, batch, cache)
            # the absolute dd phase collapses to float64 only after
            # the fractional part is taken
            f = dd_frac(ph)
            return f.hi + f.lo

        i = f0_src[1]
        f0 = (th[i] + tl[i]) if f0_src[0] == "free" else (fh[i] + fl[i])
        with record_function("fit_step.phase_jacobian"):
            if nl_idx_list:
                def sub(th_nl):
                    out = phase_f64(th.index_put((nl_idx,), th_nl))
                    return out, out

                # the primal rides along as the aux output: one pass of
                # the chain gives the residuals and the tangents
                jac_nl, frac = torch.func.jacfwd(sub, has_aux=True)(
                    th[nl_idx])
            else:
                frac = phase_f64(th)
        if lin_set:
            with record_function("fit_step.linear_columns"):
                lin_cols = model.linear_design_columns(
                    make_pv(free, frozen, th, tl, fh, fl), batch, cache,
                    lin_set)
        cols, k = [], 0
        for nm in free:
            if nm in lin_set:
                cols.append(lin_cols[nm])
            else:
                cols.append(jac_nl[:, k])
                k += 1
        if has_padd:
            frac = frac + cache["padd"]
        r = frac / f0 * valid
        if cols:
            cols = [torch.stack(cols, dim=1) / f0 * valid[:, None]]
        if incoffset:
            cols.insert(0, (valid / f0)[:, None])
        M = torch.cat(cols, dim=1)
        Fv = F * valid[:, None]
        tmask = valid
        if wideband:
            with record_function("fit_step.dm_jacobian"):
                M, r, nvec, Fv = _dm_rows(th, tl, fh, fl, batch, cache, M, r,
                                          nvec, Fv, valid)
            tmask = torch.cat([valid, torch.zeros_like(valid)])
            valid = torch.cat([valid, valid])
            eid = stack_eid(eid)
        return M, Fv, r, nvec, valid, eid, tmask

    def _dm_rows(th, tl, fh, fl, batch, cache, M, r, nvec, Fv, valid):
        """The stacked [time; DM] rows: the DM residuals in float64, the
        DM Jacobian (columns negated, r_dm = measured - model; zero in
        the Offset column; jacfwd over the DM-affecting parameters, the
        other columns zero), the DM variances and the DM-channel noise
        basis below the time rows."""
        def dm_of(thx):
            return model.dm_total_device(
                make_pv(free, frozen, thx, tl, fh, fl), batch,
                cache["main"])

        if dm_idx_list:
            def sub(th_dm):
                out = dm_of(th.index_put((dm_idx,), th_dm))
                return out, out

            jac_sub, dm = torch.func.jacfwd(sub, has_aux=True)(th[dm_idx])
            jac_dm = jac_sub.new_zeros((jac_sub.shape[0], th.shape[0]))
            jac_dm[:, dm_idx] = jac_sub
        else:
            dm = dm_of(th)
            jac_dm = dm.new_zeros((dm.shape[0], th.shape[0]))
        dm_cols = [-jac_dm * valid[:, None]]
        if incoffset:
            dm_cols.insert(0, jac_dm.new_zeros((jac_dm.shape[0], 1)))
        r_dm = (cache["wb_dm"] - dm) * valid
        return (torch.cat([M, torch.cat(dm_cols, dim=1)]),
                torch.cat([r, r_dm]),
                torch.cat([nvec, cache["wb_dme"] ** 2]),
                torch.cat([Fv, cache["wb_Fdm"] * valid[:, None]]))

    def step_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid,  # graftlint: allow G14 -- the producer: the step computes the health vector on the device (output 5); its callers observe it
                eid, jvar):
        M, Fv, r0, nvec2, valid2, _, tmask = parts_fn(
            th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid, jvar)
        if incoffset:
            # weighted-mean subtraction over the valid time rows
            wt = tmask / nvec2
            r = r0 - (torch.sum(r0 * wt) / torch.sum(wt)) * tmask
        else:
            r = r0
        dp, cov, chi2 = _gls_core(M, Fv, phi, r, nvec2, valid2, jvar,
                                  segment_plan(eid))
        # the time residuals only (the first N rows of a wideband stack)
        rt = r[:valid.shape[0]]
        if not health_on:
            return dp, cov, chi2, rt
        # the health vector: three reductions on the step's own tensors
        # — the non-finite count across its outputs, the max |whitened
        # residual| over the valid time rows, and chi2
        def nf(x):
            return torch.sum(~torch.isfinite(x)).to(torch.float64)

        hv = torch.stack([
            nf(r) + nf(dp) + nf(chi2),
            torch.max(torch.abs(r) * tmask / torch.sqrt(nvec2)),
            chi2.to(torch.float64),
        ])
        return dp, cov, chi2, rt, hv

    args = (tensor(th), tensor(tl), tensor(fh), tensor(fl), batch, sc,
            tensor(F_np), tensor(phi_np), tensor(nvec_np), tensor(valid_np),
            eid_t, tensor(jvar_np))
    meta = {"incoffset": incoffset, "nseg": nseg, "wideband": wideband,
            "has_ecorr": seg is not None, "health": health_on}
    return (step_fn, parts_fn, args,
            (["Offset"] if incoffset else []) + free, meta)


def build_fit_step(model, toas, device=None, hybrid_jac=False,
                   wideband=False, pad_to=None, health=None):
    """(step_fn, args, names): one fit iteration and its arguments on
    ``device`` (the model's by default); see ``_build_fit_core``. With
    ``health`` armed (or $PINT_TPU_HEALTH) the step returns a FIFTH
    output, the health vector [nonfinite_count, max_resid_sigma, chi2];
    disarmed, the 4-tuple and the ops that make it are the ones of a
    step built without health."""
    step_fn, _, args, names, _ = _build_fit_core(
        model, toas, device, hybrid_jac, wideband, pad_to=pad_to,
        health=health)
    return step_fn, args, names


def build_fit_parts(model, toas, device=None, hybrid_jac=False,
                    wideband=False, arg_device=None):
    """(parts_fn, args, names, meta): the design/residual assembly half
    of the step, taking the same 12 arguments as ``step_fn``; ``args``
    on ``arg_device`` (``device`` by default)."""
    _, parts_fn, args, names, meta = _build_fit_core(
        model, toas, device, hybrid_jac, wideband, arg_device)
    return parts_fn, args, names, meta


def build_fit_loop(model, toas, max_iter: int = 8,
                   min_lambda: float = 1e-3,
                   required_chi2_decrease: float = 1e-2, device=None,
                   **step_flags):
    """Up to ``max_iter`` downhill GLS iterations of the step, the
    step-halving line search included, plus the ledger of applied
    updates for an exact host replay (reference: build_fit_loop; the
    decisions are ``gls.downhill_dd``'s).

    Returns ``(loop_fn, args, names)``, ``args`` ending in the default
    budget ``max_iter``, with

        loop_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid,
                eid, jvar, budget, entry=None) -> (th', tl', dp, cov,
                    best_chi2, chi2_0, niter, converged, deltas, lams,
                    nevals)

    ``deltas`` (max_iter, p) the applied parameter updates (zero rows
    beyond ``niter`` or on a rejected iteration), ``lams`` (max_iter,)
    the accepted step factors (0 = rejected or unused), ``chi2_0`` the
    chi2 at the entry point, ``converged`` True when the loop stopped
    for a reason other than its iteration limit, ``nevals`` the step
    evaluations run (the entry step, unless given, and every trial).
    ``budget`` is a runtime limit: the loop stops at min(max_iter,
    budget). ``entry``, the ``(dp, cov, best_chi2)`` a previous call
    returned for this (th, tl) (and its health vector when the step is
    armed), stands in for the entry step, so that chained calls evaluate
    each point once (not in the reference, whose chained dispatches
    re-evaluate it). With the step's health armed (``health=True`` or
    $PINT_TPU_HEALTH) a twelfth output follows: the health vector of
    the accepted state (a rejected trial's is never kept: an overshoot
    that the line search halves is the damping working, not an
    incident).

    The loop is a host loop over device tensors: the step never syncs,
    and each trial reads one scalar, its chi2, for the accept test (a
    float64 comparison on the host is the device's, bit for bit). The
    tensors come back on the device; ``niter``, ``converged`` and
    ``nevals`` are Python values. (th, tl) advance by the dd two-sum
    ``dd_add(dd(th, tl), dd(delta))``, the counterpart of the host's
    ``dd_np.add(dd_np.dd(th, tl), dd_np.dd(delta))``, so replaying
    ``deltas`` on the host gives (th', tl') bit for bit. ``step_flags``
    (``hybrid_jac``, ``wideband``, ``pad_to``, ``health``) go to
    ``build_fit_step``."""
    from pint_tpu_torch import config

    step_fn, args, names = build_fit_step(model, toas, device, **step_flags)
    # the step's own resolution of its health flag
    health_on = config.health_enabled(step_flags.get("health"))
    nev = 4 if health_on else 3
    noff = 1 if names and names[0] == "Offset" else 0
    K = int(max_iter)

    def advance(th, tl, d):
        s = dd_add(dd(th, tl), dd(d))
        return s.hi, s.lo

    def loop_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid,
                jvar, budget, entry=None):
        def evaluate(a, b):
            out = step_fn(a, b, fh, fl, batch, cache, F, phi, nvec, valid,
                          eid, jvar)
            # (dp, cov, chi2) and, armed, the health vector
            ev = out[:3] + out[4:] if health_on else out[:3]
            return ev, float(ev[2])

        nevals = 0
        if entry is None:
            entry = evaluate(th, tl)
            nevals = 1
        else:
            entry = tuple(entry)[:nev], float(entry[2])
        th, tl, ev, _, ledger, done, ntrials = downhill_dd(
            evaluate, advance, th, tl, entry, min(K, int(budget)),
            min_lambda, required_chi2_decrease, noff)
        deltas = th.new_zeros((K, th.shape[0]))
        lams = th.new_zeros(K)
        for k, (delta, lam) in enumerate(ledger):
            if lam > 0.0:
                deltas[k], lams[k] = delta, lam
        out = (th, tl, ev[0], ev[1], ev[2], entry[0][2], len(ledger),
               done, deltas, lams, nevals + ntrials)
        # armed: the accepted state's health vector, appended at the END
        # so every other index is untouched
        return out + (ev[3],) if health_on else out

    return loop_fn, args + (K,), names


def _gls_core(M, F, phi, r, nvec, valid, jvar, seg=None):
    """The basis-Woodbury solve of ``pint_tpu.gls`` with ECORR as the
    effective white covariance N_eff = diag(nvec) + sum_k jvar_k u_k u_k^T
    (u_k the indicator of epoch k). Each epoch block is rank-1, so for
    any vectors a, b (Sherman-Morrison)
        a^T N_eff^-1 b = a^T W b - sum_k g_k (u_k^T W a)(u_k^T W b),
        g_k = jvar_k / (1 + jvar_k s_k),  s_k = u_k^T w,  W = diag(w);
    the u_k^T W contractions are the segment sums ``seg`` (None: no
    ECORR). Returns (dparams, cov, chi2)."""
    p = M.shape[1]
    q = F.shape[1]
    with record_function("fit_step.gram"):
        w = valid / nvec
        Mn, colmax, norm = equilibrate(M, w)
        big = torch.cat([Mn, F], dim=1)
        # symmetric sqrt(w) split: Sigma is exactly symmetric
        sw = torch.sqrt(w)
        bigs = big * sw[:, None]
        rs = r * sw
        Sigma = bigs.T @ bigs
        b = bigs.T @ rs
        rCr = torch.sum(rs * rs)
    if seg is not None:
        with record_function("fit_step.ecorr_segments"):
            s_seg = seg(w)
            g = jvar / (1.0 + jvar * s_seg)
            E = seg(big * w[:, None])
            wr_seg = seg(w * r)
            sg = torch.sqrt(g)
            Eg = E * sg[:, None]
            Sigma = Sigma - Eg.T @ Eg
            b = b - Eg.T @ (sg * wr_seg)
            rCr = rCr - torch.sum(g * wr_seg ** 2)
    with record_function("fit_step.cholesky_solves"):
        zeros = torch.zeros(p, dtype=M.dtype, device=M.device)
        Sigma = Sigma + torch.diag(torch.cat([zeros, 1.0 / phi]) if q
                                   else zeros)
        # Jacobi-precondition to unit diagonal: Sigma mixes O(1) data
        # terms with 1/phi priors up to ~1e25
        d = jacobi(Sigma)
        dd = torch.outer(d, d)
        L = cho_factor(Sigma / dd)
        xhat = cho_solve(L, b / d) / d
        eye = torch.eye(p + q, dtype=M.dtype, device=M.device)
        inv = cho_solve(L, eye) / dd
        # chi2 at the point: marginalize the noise (F-basis + ECORR)
        # only, not the parameter block
        if q:
            bF, dF = b[p:], d[p:]
            LF = cho_factor(Sigma[p:, p:] / torch.outer(dF, dF))
            chi2 = rCr - bF @ (cho_solve(LF, bF / dF) / dF)
        else:
            chi2 = rCr
        dparams = -xhat[:p] / colmax / norm  # r ≈ M(θ−θ_true): −x
        cov = inv[:p, :p] / torch.outer(colmax, colmax) \
            / torch.outer(norm, norm)
    return dparams, cov, chi2
