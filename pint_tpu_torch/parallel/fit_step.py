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

By default the step takes the route the reference takes on its CPU
backend, where float64 is IEEE, as it is on the GPU: the direct dd phase
chain, the float64 Jacobian and the float64 Gram, with the reference's
hybrid Jacobian split an option (off by default, see
``_build_fit_core``). The reference's three precision routes are opt-in
flags, each also read from its environment variable through
``config.f32_mode`` (values f32/f64/on/off):

- ``anchored`` ($PINT_TPU_ANCHORED): the host computes the exact
  reference phase once (``TimingModel.build_anchor``) and the step
  evaluates only the small difference; its (th, tl) slots then carry
  delta theta against the anchor (zeros in the returned args);
- ``jac_f32`` ($PINT_TPU_JAC): the design matrix from a float32/dd32
  re-run of the same phase chain, with per-parameter power-of-two
  scales for the high spin terms (F8 and up fall back to float64);
- ``matmul_f32`` ($PINT_TPU_GLS_MATMUL): the Gram products in float32
  (no TF32), the float64 Gram taken instead where the float32 Cholesky
  fails. Left unset it follows ``jac_f32``.

Auto (None and no environment variable) is float64 for every route off
a TPU, so on the GPU and the CPU each route runs only when asked for,
and the default step runs exactly the ops it runs without them.

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

``build_sharded_fit_step`` runs the same step with its TOA axis split
over a device mesh (``pta.shard.Mesh``): each block's rows through
``parts_fn`` on its device, every reduction over the TOA axis across the
blocks, one solve (reference: build_sharded_fit_step).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from pint_tpu_torch import obs

from pint_tpu_torch import gls as _gls
from pint_tpu_torch import resolve_device
from pint_tpu_torch.gls import cho_factor, cho_solve, downhill_dd, \
    equilibrate_blocks, jacobi, reduce_blocks
from pint_tpu_torch.models.timing_model import make_pv
from pint_tpu_torch.ops.dd import DD, dd, dd_add, dd_frac, dd_to_dd32

__all__ = ["build_fit_step", "build_fit_parts", "build_fit_loop",
           "build_sharded_fit_step", "toa_sharding", "ToaSharding",
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


def _resolve_f32(flag, env_name: str) -> bool:
    """A precision route's resolution: an explicit argument, else the
    environment variable (``config.f32_mode``: f32/f64/on/off; an
    unrecognized value warns once and counts as unset), else auto. The
    reference's auto picks float32 only on a TPU, whose float64 is
    emulated; off a TPU it is float64, so here auto is always off."""
    from pint_tpu_torch.config import f32_mode

    mode = f32_mode(env_name, flag)
    return bool(mode) if mode is not None else False


def _use_f32_matmul(flag) -> bool:
    """The normal equations' Gram in float32 ($PINT_TPU_GLS_MATMUL): the
    equilibrated normal equations need ~1e-7 relative accuracy, which
    float32 products without TF32 give."""
    return _resolve_f32(flag, "PINT_TPU_GLS_MATMUL")


def _use_anchored(flag) -> bool:
    """The anchored delta phase ($PINT_TPU_ANCHORED): the host computes
    the exact reference phase once and the step evaluates only the small
    difference, so no ~1e10-turn intermediate survives."""
    return _resolve_f32(flag, "PINT_TPU_ANCHORED")


def _use_f32_jac(flag) -> bool:
    """The design matrix in float32 ($PINT_TPU_JAC): the same phase chain
    run with float32 inputs, dd ops as dd32 pairs (~2^-48). Design
    columns need ~1e-6 relative accuracy; the residuals keep the float64
    dd chain."""
    return _resolve_f32(flag, "PINT_TPU_JAC")


def _tree_to32(tree):
    """Every float64 tensor of dicts and NamedTuples cast to float32, dd
    pairs split by ``dd_to_dd32`` (48 bits survive)."""
    def conv(x):
        if isinstance(x, DD):
            return dd_to_dd32(x)
        if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
            return x.to(torch.float32)
        return x

    def walk(x):
        if isinstance(x, DD):
            return conv(x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        return conv(x)

    return walk(tree)


def _split32(hi, lo=None):
    """Device-side float64 (+ float64) -> dd32 split: (float32 head,
    float32 remainder)."""
    d = dd_to_dd32(DD(hi, torch.zeros_like(hi) if lo is None else lo))
    return d.hi, d.lo


def _spin_scales(model, free, batch):
    """(scale, jac32): the float32 Jacobian's power-of-two scale of each
    free parameter. F_i (i >= 2) columns are dt^(i+1)/(i+1)! and leave
    float32 range from i = 4; differentiating with respect to
    u_i = F_i 2^e keeps scaled columns ~O(dt). Each exponent lies in the
    window where both the scaled column stays in normal float32 range and
    the tangent seed s/(i+1)! stays normal. Where no window exists (F8
    and up over decade spans) jac32 comes back False: the step falls back
    to the float64 Jacobian, correct and slower."""
    scale = np.ones(len(free))
    mjd = batch.tdb_day.cpu().numpy() + batch.tdb_frac.hi.cpu().numpy()
    T = max(float(np.max(np.abs(mjd - model.ref_day))) * 86400.0, 1.0)
    L = math.log2(T)
    for i, nm in enumerate(free):
        p = model.get_param(nm)
        if getattr(p, "prefix", None) == "F" and \
                getattr(p, "index", 0) >= 2:
            idx = p.index
            lf = math.log2(math.factorial(idx + 1))
            e_hi = 122.0 - lf                     # tangent seed normal
            e_lo = (idx + 1) * L - lf - 120.0     # column in range
            if e_lo > e_hi:
                return np.ones(len(free)), False
            e = int(min(max(round(idx * L), math.ceil(e_lo), 0),
                        math.floor(e_hi), 126))
            scale[i] = 2.0 ** (-e)
    return scale, True


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
                    health=None, anchored=None, jac_f32=None,
                    matmul_f32=None):
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
    (module docstring). ``anchored``, ``jac_f32`` and ``matmul_f32``
    are the precision routes (module docstring); None reads each one's
    environment variable, and auto is float64. The anchored route falls
    back to the direct chain, with a warning, on a model without a
    frozen PEPOCH or when the anchor cannot be built.

    Every design column comes from one vmapped jacfwd over all free
    parameters. ``hybrid_jac=True`` takes the reference's default
    instead: closed-form columns for the linear parameters and jacfwd
    over the rest. Eager, the closed-form columns cost a second delay
    chain and a stage-sensitivity JVP over the whole chain (main and
    TZR rows), while more tangents do not add launches (vmap), so the
    all-jacfwd step is the faster one (PERF.md)."""
    from pint_tpu_torch import config
    from pint_tpu_torch.config import f32_mode

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
    noff = 1 if incoffset else 0
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

    f32mm = _use_f32_matmul(matmul_f32)
    jac32 = _use_f32_jac(jac_f32)
    scale_np = np.ones(len(free))
    if jac32:
        scale_np, jac32 = _spin_scales(model, free, batch)
    if matmul_f32 is None and f32_mode("PINT_TPU_GLS_MATMUL") is None:
        # left unset, the Gram follows the final Jacobian dtype (after
        # the F8+ fallback above): float32 columns lose nothing to a
        # float32 Gram, and _gls_core takes the float64 Gram where the
        # float32 Cholesky fails
        f32mm = f32mm or jac32

    # with hybrid_jac, closed-form columns for the linear params and AD
    # tangents only for the rest (static split at build time). A
    # parameter the float32 scales touch stays on AD: the closed-form
    # columns are d(phase)/d(theta), the AD ones d(phase)/d(u)
    lin_set = model.linear_design_names() if hybrid_jac else set()
    lin_set = {nm for i, nm in enumerate(free)
               if nm in lin_set and scale_np[i] == 1.0}
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

    # anchored delta phase: the host computes the exact reference once;
    # the step's (th, tl) slots then carry delta theta - theta_ref
    anchored_on = _use_anchored(anchored) and model.supports_anchored()
    afn = None
    f0_ref = 0.0
    if anchored_on:
        try:
            anc_arrays, anc_static = model.build_anchor(toas, adev)
            afn = model._build_anchored_fn(anc_static)
        except Exception as e:
            # on an IEEE backend the direct chain is equally exact: the
            # reference degrades to it with this warning
            from pint_tpu_torch.logging import log

            log.warning(
                "anchored fit-step build failed (%r); falling back "
                "to the direct phase chain (exact on this backend)", e)
            anchored_on = False
        else:
            sc = {**sc, "anchor": {k: tensor(v)
                                   for k, v in anc_arrays.items()}}
            f0_ref = anc_static["fref"][0]

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

    # the float32 Jacobian's constants, made once on the step's device:
    # the column scales (float64 and their exact float32 twins) and the
    # unscale vector of (dparams, cov)
    sfull_np = np.concatenate([np.ones(noff), scale_np])
    if jac32:
        s64 = torch.as_tensor(scale_np, dtype=torch.float64, device=dev)
        s32 = s64.to(torch.float32)
        sfull = torch.as_tensor(sfull_np, dtype=torch.float64, device=dev)

    def make_pv_x(thx, tlx, fhx, flx):
        """pv for the auxiliary channels (DM rows, hybrid columns): in
        anchored mode the anchored function's, reference + delta."""
        if anchored_on:
            return afn.pv_of(thx, tlx, fhx, flx)
        return make_pv(free, frozen, thx, tlx, fhx, flx)

    def parts_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid,
                 eid, jvar):
        """Design/residual assembly: (M, Fv, r0, nvec, valid, eid,
        tmask), r0 the masked residuals WITHOUT the weighted-mean
        subtraction."""
        if anchored_on:
            def phase_f64(thx):
                fr, _ = afn(thx, tl, fh, fl, batch, cache)
                return fr
        else:
            def phase_f64(thx):
                ph, _ = phase_fn(thx, tl, fh, fl, batch, cache)
                # the absolute dd phase collapses to float64 only after
                # the fractional part is taken
                f = dd_frac(ph)
                return f.hi + f.lo

        i = f0_src[1]
        if anchored_on and f0_src[0] == "free":
            f0 = f0_ref + (th[i] + tl[i])  # th carries delta theta
        else:
            f0 = (th[i] + tl[i]) if f0_src[0] == "free" \
                else (fh[i] + fl[i])
        x32 = None
        if jac32:
            x32 = _inputs32(th, tl, fh, fl, batch, cache)
            frac, M = _jacobian32(th, x32, f0, valid, phase_f64)
        else:
            frac, M = _jacobian64(th, tl, fh, fl, batch, cache, f0, valid,
                                  phase_f64)
        if has_padd:
            frac = frac + cache["padd"]
        r = frac / f0 * valid
        Fv = F * valid[:, None]
        tmask = valid
        if wideband:
            with obs.span("fit_step.dm_jacobian"):
                M, r, nvec, Fv = _dm_rows(th, tl, fh, fl, batch, cache, M, r,
                                          nvec, Fv, valid, x32)
            tmask = torch.cat([valid, torch.zeros_like(valid)])
            valid = torch.cat([valid, valid])
            eid = stack_eid(eid)
        return M, Fv, r, nvec, valid, eid, tmask

    def _assemble(jac_nl, lin_cols, f0, valid):
        """The design matrix: the AD and closed-form columns in free
        order, over f0, masked, the Offset column first."""
        cols, k = [], 0
        for nm in free:
            if nm in lin_set:
                cols.append(lin_cols[nm])
            else:
                cols.append(jac_nl[:, k])
                k += 1
        if cols:
            cols = [torch.stack(cols, dim=1) / f0 * valid[:, None]]
        if incoffset:
            cols.insert(0, (valid / f0)[:, None])
        return torch.cat(cols, dim=1)

    def _jacobian64(th, tl, fh, fl, batch, cache, f0, valid, phase_f64):
        """(frac, M): the fractional phase and the float64 design
        matrix, the primal riding along jacfwd's tangents."""
        with obs.span("fit_step.phase_jacobian"):
            jac_nl = None
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
        lin_cols = None
        if lin_set:
            with obs.span("fit_step.linear_columns"):
                lin_cols = model.linear_design_columns(
                    make_pv_x(th, tl, fh, fl), batch, cache, lin_set)
        return frac, _assemble(jac_nl, lin_cols, f0, valid)

    if jac32:
        def _inputs32(th, tl, fh, fl, batch, cache):
            """The float32 re-run's inputs, split on the device (the
            step's arguments stay float64): the batch and cache as dd32
            and float32, the free pairs at the scaled point u = theta / s,
            the frozen pairs."""
            ua, ub = _split32(th / s64, tl / s64)
            fa, fb = _split32(fh, fl)
            return _tree_to32(batch), _tree_to32(cache), ua, ub, fa, fb

        def _jacobian32(th, x32, f0, valid, phase_f64):
            """(frac, M): the fractional phase from the float64 chain
            and the design matrix from the float32/dd32 re-run of the
            same chain on ``x32`` (``_inputs32``)."""
            batch32, cache32, ua, ub, fa, fb = x32
            with obs.span("fit_step.phase_jacobian"):
                frac = phase_f64(th)
                if anchored_on:
                    def phase32(ua_):
                        fr, _ = afn(ua_ * s32, ub * s32, fa, fb, batch32,
                                    cache32)
                        return fr
                else:
                    def phase32(ua_):
                        ph, _ = phase_fn(ua_ * s32, ub * s32, fa, fb,
                                         batch32, cache32)
                        return ph.hi + ph.lo

                jac_nl = None
                if nl_idx_list:
                    def sub32(u_nl):
                        return phase32(ua.index_put((nl_idx,), u_nl))

                    jac_nl = torch.func.jacfwd(sub32)(ua[nl_idx])
            lin_cols = None
            if lin_set:
                with obs.span("fit_step.linear_columns"):
                    lin_cols = model.linear_design_columns(
                        make_pv_x(ua * s32, ub * s32, fa, fb), batch32,
                        cache32, lin_set)
            return frac, _assemble(jac_nl, lin_cols,
                                   f0.to(torch.float32),
                                   valid.to(torch.float32))

    def _dm_rows(th, tl, fh, fl, batch, cache, M, r, nvec, Fv, valid, x32):
        """The stacked [time; DM] rows: the DM residuals in float64, the
        DM Jacobian (columns negated, r_dm = measured - model; zero in
        the Offset column; jacfwd over the DM-affecting parameters, the
        other columns zero; in float32 at the scaled point with
        jac_f32, as the time rows), the DM variances and the DM-channel
        noise basis below the time rows."""
        def dm_of(thx):
            return model.dm_total_device(
                make_pv_x(thx, tl, fh, fl), batch, cache["main"])

        if jac32:
            dm = dm_of(th)
            batch32, cache32, ua, ub, fa, fb = x32
            rows_valid = valid.to(torch.float32)

            def dm_of32(ua_):
                return model.dm_total_device(
                    make_pv_x(ua_ * s32, ub * s32, fa, fb), batch32,
                    cache32["main"])

            jac_dm = ua.new_zeros((dm.shape[0], th.shape[0]))
            if dm_idx_list:
                def sub32(u_dm):
                    return dm_of32(ua.index_put((dm_idx,), u_dm))

                jac_dm[:, dm_idx] = torch.func.jacfwd(sub32)(ua[dm_idx])
        elif dm_idx_list:
            rows_valid = valid

            def sub(th_dm):
                out = dm_of(th.index_put((dm_idx,), th_dm))
                return out, out

            jac_sub, dm = torch.func.jacfwd(sub, has_aux=True)(th[dm_idx])
            jac_dm = jac_sub.new_zeros((jac_sub.shape[0], th.shape[0]))
            jac_dm[:, dm_idx] = jac_sub
        else:
            rows_valid = valid
            dm = dm_of(th)
            jac_dm = dm.new_zeros((dm.shape[0], th.shape[0]))
        dm_cols = [-jac_dm * rows_valid[:, None]]
        if incoffset:
            dm_cols.insert(0, jac_dm.new_zeros((jac_dm.shape[0], 1)))
        r_dm = (cache["wb_dm"] - dm) * valid
        return (torch.cat([M, torch.cat(dm_cols, dim=1)]),
                torch.cat([r, r_dm]),
                torch.cat([nvec, cache["wb_dme"] ** 2]),
                torch.cat([Fv, cache["wb_Fdm"] * valid[:, None]]))

    def finish(parts, phi, jvar, segs):  # graftlint: allow G14 -- the producer: the step computes the health vector on the device (output 5); its callers observe it
        """The step's outputs from ``parts_fn``'s outputs over one or
        more row blocks of the TOA axis (``parts``, in block order, each
        on its own device; ``segs`` their segment plans, None without
        ECORR): the weighted mean, the GLS solve and the health vector
        reduce across the blocks on the first block's device, where the
        outputs land; ``resids`` is the blocks' time rows in block
        order. One block is the step itself."""
        if incoffset:
            # weighted-mean subtraction over the valid time rows
            wts = [tm / nv for _, _, _, nv, _, _, tm in parts]
            mean = reduce_blocks([torch.sum(pt[2] * wt)
                                  for pt, wt in zip(parts, wts)]) \
                / reduce_blocks([torch.sum(wt) for wt in wts])
            rs = [pt[2] - mean.to(pt[2].device) * pt[6] for pt in parts]
        else:
            rs = [pt[2] for pt in parts]
        dp, cov, chi2 = _gls_core_blocks(
            [(pt[0], pt[1], r, pt[3], pt[4]) for pt, r in zip(parts, rs)],
            phi, jvar, segs, f32mm=f32mm)
        if jac32:
            # back from the scaled parameters u = theta / s
            dp = dp * sfull
            cov = cov * torch.outer(sfull, sfull)
        # the time residuals only (the first rows of a wideband stack)
        rts = [r[:pt[6].shape[0] // (2 if wideband else 1)]
               for pt, r in zip(parts, rs)]
        rt = rts[0] if len(rts) == 1 else \
            torch.cat([x.to(dp.device) for x in rts])
        if not health_on:
            return dp, cov, chi2, rt
        # the health vector: three reductions on the step's own tensors
        # — the non-finite count across its outputs, the max |whitened
        # residual| over the valid time rows, and chi2
        def nf(x):
            return torch.sum(~torch.isfinite(x)).to(torch.float64)

        hv = torch.stack([
            reduce_blocks([nf(r) for r in rs]) + nf(dp) + nf(chi2),
            reduce_blocks([torch.max(torch.abs(r) * pt[6]
                                     / torch.sqrt(pt[3]))
                           for pt, r in zip(parts, rs)], torch.maximum),
            chi2.to(torch.float64),
        ])
        return dp, cov, chi2, rt, hv

    def step_fn(th, tl, fh, fl, batch, cache, F, phi, nvec, valid,
                eid, jvar):
        parts = parts_fn(th, tl, fh, fl, batch, cache, F, phi, nvec,
                         valid, eid, jvar)
        seg = segment_plan(eid)
        return finish([parts], phi, jvar, None if seg is None else [seg])

    if anchored_on:
        # the (th, tl) slots carry delta theta against the anchor: zero
        # at the reference point build_anchor just captured
        th, tl = np.zeros_like(th), np.zeros_like(tl)
    args = (tensor(th), tensor(tl), tensor(fh), tensor(fl), batch, sc,
            tensor(F_np), tensor(phi_np), tensor(nvec_np), tensor(valid_np),
            eid_t, tensor(jvar_np))
    meta = {"incoffset": incoffset, "nseg": nseg, "wideband": wideband,
            "has_ecorr": seg is not None, "health": health_on,
            "f32mm": f32mm, "jac32": jac32, "sfull": sfull_np,
            "anchored": anchored_on, "stack_eid": stack_eid,
            "finish": finish}
    return (step_fn, parts_fn, args,
            (["Offset"] if incoffset else []) + free, meta)


def build_fit_step(model, toas, device=None, hybrid_jac=False,
                   wideband=False, pad_to=None, health=None, anchored=None,
                   jac_f32=None, matmul_f32=None):
    """(step_fn, args, names): one fit iteration and its arguments on
    ``device`` (the model's by default); see ``_build_fit_core``. With
    ``health`` armed (or $PINT_TPU_HEALTH) the step returns a FIFTH
    output, the health vector [nonfinite_count, max_resid_sigma, chi2];
    disarmed, the 4-tuple and the ops that make it are the ones of a
    step built without health. ``anchored``, ``jac_f32`` and
    ``matmul_f32`` are the opt-in precision routes (module docstring)."""
    step_fn, _, args, names, _ = _build_fit_core(
        model, toas, device, hybrid_jac, wideband, pad_to=pad_to,
        health=health, anchored=anchored, jac_f32=jac_f32,
        matmul_f32=matmul_f32)
    return step_fn, args, names


def build_fit_parts(model, toas, device=None, hybrid_jac=False,
                    wideband=False, arg_device=None, anchored=None,
                    jac_f32=None, matmul_f32=None):
    """(parts_fn, args, names, meta): the design/residual assembly half
    of the step, taking the same 12 arguments as ``step_fn``; ``args``
    on ``arg_device`` (``device`` by default). ``meta`` carries what a
    consumer needs to finish the algebra as ``step_fn`` does:
    incoffset, nseg, has_ecorr, the routes as resolved (f32mm, jac32,
    anchored) and the float32 Jacobian's unscale vector ``sfull``."""
    _, parts_fn, args, names, meta = _build_fit_core(
        model, toas, device, hybrid_jac, wideband, arg_device,
        anchored=anchored, jac_f32=jac_f32, matmul_f32=matmul_f32)
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
    (``hybrid_jac``, ``wideband``, ``pad_to``, ``health`` and the
    precision routes ``anchored``, ``jac_f32``, ``matmul_f32``) go to
    ``build_fit_step``; in anchored mode (th, tl) are deltas against the
    anchor, and the ledger replays the same way."""
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


# ---------------------------------------------------------------- mesh

# cache entries whose every leaf carries the TOA axis on dim 0: the
# components' per-TOA columns, the PHASE offsets and the wideband DM
# channel; the TZR entries are one row, replicated
_TOA_CACHE = ("main", "padd", "wb_dm", "wb_dme", "wb_Fdm")
_TZR_CACHE = ("tzr", "tzr_batch")


class ToaSharding:
    """The placement of a fit step's arguments over a mesh axis: the TOA
    axis in contiguous equal blocks, block i on the axis's i-th device
    (``pta.shard.mesh_devices``), everything else replicated.

    Which leaves carry the TOA axis is named by structure, never read
    off a shape (a leaf whose dim 0 happens to equal N is not split for
    that): F, nvec, valid and eid; every ToaBatch leaf (the (P, N, 3)
    planet stack on dim 1, the rest on dim 0); every leaf of the cache
    entries in ``_TOA_CACHE``; the anchor's per-TOA references (its
    ``*_tzr`` leaves are the TZR row). Replicated: the parameter pairs,
    phi, jvar, the TZR batch and cache. A cache entry with no rule
    raises, and so does a split leaf whose TOA axis is not N long."""

    def __init__(self, mesh, axis: str = "toa"):
        from pint_tpu_torch.pta.shard import mesh_devices

        self.devices = mesh_devices(mesh, axis)
        self.nshard = len(self.devices)

    def bounds(self, n: int):
        """[(start, stop)] of each block of ``n`` rows."""
        if n % self.nshard:
            raise ValueError(f"{n} TOA rows do not split into "
                             f"{self.nshard} equal blocks")
        k = n // self.nshard
        return [(i * k, (i + 1) * k) for i in range(self.nshard)]

    def split(self, a, n: int, dim: int = 0) -> list:
        """``a``'s blocks along ``dim`` (N = ``n`` long), each on its
        device."""
        if not isinstance(a, torch.Tensor):
            return [a] * self.nshard
        if a.ndim <= dim or a.shape[dim] != n:
            raise ValueError(f"a TOA-axis leaf of shape {tuple(a.shape)} "
                             f"is not {n} long on dim {dim}")
        return [a.narrow(dim, lo, hi - lo).contiguous().to(d)
                for (lo, hi), d in zip(self.bounds(n), self.devices)]

    def replicate(self, a) -> list:
        """``a`` on every block's device (a no-op where it lies)."""
        return [_tree_map(lambda x: x.to(d) if isinstance(x, torch.Tensor)
                          else x, a) for d in self.devices]

    def _split_tree(self, tree, n: int, dim: int = 0) -> list:
        per = _tree_map(lambda a: self.split(a, n, dim), tree)
        return [_tree_map(lambda x: x[i], per) for i in range(self.nshard)]

    def split_batch(self, batch, n: int) -> list:
        fields = {f: self._split_tree(getattr(batch, f), n,
                                      1 if f == "obs_planet_pos" else 0)
                  for f in batch._fields}
        return [type(batch)(**{f: v[i] for f, v in fields.items()})
                for i in range(self.nshard)]

    def split_cache(self, cache: dict, n: int) -> list:
        out = [dict() for _ in range(self.nshard)]
        for key, val in cache.items():
            if key in _TOA_CACHE:
                per = self._split_tree(val, n)
            elif key in _TZR_CACHE:
                per = self.replicate(val)
            elif key == "anchor":
                sub = {k: (self.replicate(v) if k.endswith("_tzr")
                           else self.split(v, n)) for k, v in val.items()}
                per = [{k: v[i] for k, v in sub.items()}
                       for i in range(self.nshard)]
            else:
                raise ValueError(f"no TOA-axis rule for the cache entry "
                                 f"{key!r}")
            for i in range(self.nshard):
                out[i][key] = per[i]
        return out

    def place(self, args, n: int) -> tuple:
        """A step's 12 arguments placed: the replicated ones as they are
        (each block's device gets its copy in the step), each TOA-axis
        one as a ``pta.shard.Blocks`` of its per-block values."""
        from pint_tpu_torch.pta.shard import Blocks

        th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid, jvar = args
        return (th, tl, fh, fl, Blocks(self.split_batch(batch, n)),
                Blocks(self.split_cache(cache, n)),
                Blocks(self.split(F, n)), phi, Blocks(self.split(nvec, n)),
                Blocks(self.split(valid, n)), Blocks(self.split(eid, n)),
                jvar)


def toa_sharding(mesh, axis: str = "toa") -> ToaSharding:
    """The TOA-axis placement of a fit step over ``mesh``'s ``axis``
    (``ToaSharding``)."""
    return ToaSharding(mesh, axis)


def build_sharded_fit_step(model, toas, mesh, axis: str = "toa", **flags):
    """The fit step with its TOA axis split over ``mesh``'s ``axis``
    (``pta.shard.Mesh``; reference: build_sharded_fit_step). N is padded
    to a multiple of the axis size with masked rows (``pad_to``);
    ``flags`` (``anchored``, ``jac_f32``, ``matmul_f32``, ``wideband``,
    ``health``, ``hybrid_jac``) go to the step's builder.

    Returns ``(supervised, dev_args, names)``; ``supervised(*dev_args)``
    gives ``(dparams, cov, chi2, resids[, hv])`` on the mesh's first
    device, ``resids`` padded (its pad rows exactly 0). Each block runs
    ``parts_fn`` on its rows on its device (the delay and phase chain,
    the residuals, the design matrix: all per row); then every sum or
    max over the TOA axis is reduced across the blocks on the first
    device (``finish``): the weighted mean before any residual is final,
    the column scales, the Grams, rCr, the ECORR segment sums (an epoch
    may straddle two blocks; each block sums into the global epochs)
    and the health vector, and the solve runs once there. A one-block
    mesh runs exactly the ops of the unsharded step.

    One process drives every device, as the reference's single
    controller does: the blocks are issued in order and run
    asynchronously on their devices. Each distinct device gets its own
    build (a copy of the model homed there where the model lives
    elsewhere). The call is a supervised dispatch under key and span
    ``fit_step.sharded``, on the breaker of the mesh's first device,
    where the reductions and the solve run and the outputs land.
    ``supervised.step`` is the undispatched step (CUDA-graph capture)."""
    from pint_tpu_torch.models.timing_model import copy_model

    plan = toa_sharding(mesh, axis)
    pad_to = _pad_to(toas.ntoas, plan.nshard)
    mdev = torch.device(model.device)
    if mdev.type == "cuda" and mdev.index is None:
        mdev = torch.device("cuda", torch.cuda.current_device())
    cores = {}
    for d in plan.devices:
        if d not in cores:
            # the model's own device as it names it (its cache is keyed
            # on the name: "cuda" and "cuda:0" would rebuild it)
            m, md = model, model.device
            if mdev != d:
                m, md = copy_model(model), d
                m.device = d
            cores[d] = _build_fit_core(m, toas, device=md, pad_to=pad_to,
                                       **flags)
    home = plan.devices[0]
    _, _, args, names, meta = cores[home]
    dev_args = plan.place(args, pad_to)
    finish, stack_eid, nseg = meta["finish"], meta["stack_eid"], \
        meta["nseg"]
    segs: dict = {}

    def segment_plans(eid):
        """Each block's segment plan over the global epoch ids (made on
        the first call with these eid blocks)."""
        if nseg <= 1:
            return None
        key = tuple(id(e) for e in eid)
        if segs.get("key") != key:
            segs.update(key=key, plans=[SegmentSum(stack_eid(e), nseg)
                                        for e in eid])
        return segs["plans"]

    segment_plans(dev_args[10])

    def step(th, tl, fh, fl, batch, cache, F, phi, nvec, valid, eid,
             jvar):
        parts = []
        for i, d in enumerate(plan.devices):
            parts.append(cores[d][1](
                th.to(d), tl.to(d), fh.to(d), fl.to(d), batch[i],
                cache[i], F[i], phi.to(d), nvec[i], valid[i], eid[i],
                jvar.to(d)))
        return finish(parts, phi, jvar, segment_plans(eid))

    def supervised(*step_args):
        """The sharded step as a supervised dispatch (key and span
        ``fit_step.sharded``)."""
        from pint_tpu_torch import obs
        from pint_tpu_torch.runtime import get_supervisor

        with obs.span("fit_step.sharded", nshard=plan.nshard):
            return get_supervisor().dispatch(
                step, *step_args, key="fit_step.sharded", device=home)

    supervised.step = step
    return supervised, dev_args, names


def _gls_core(M, F, phi, r, nvec, valid, jvar, seg=None, f32mm=False):
    """The basis-Woodbury solve of ``pint_tpu.gls`` with ECORR as the
    effective white covariance N_eff = diag(nvec) + sum_k jvar_k u_k u_k^T
    (u_k the indicator of epoch k). Each epoch block is rank-1, so for
    any vectors a, b (Sherman-Morrison)
        a^T N_eff^-1 b = a^T W b - sum_k g_k (u_k^T W a)(u_k^T W b),
        g_k = jvar_k / (1 + jvar_k s_k),  s_k = u_k^T w,  W = diag(w);
    the u_k^T W contractions are the segment sums ``seg`` (None: no
    ECORR). Returns (dparams, cov, chi2).

    A float32 ``M`` (the float32 Jacobian) keeps the (N, p+q)-wide
    elementwise work in float32, while the (N,) vectors and the (p+q)^2
    solve stay float64. ``f32mm`` takes the Gram products in float32
    (``gls._symm_mm``); where that solve fails (a non-finite result, or
    an inverse with a negative diagonal: a float32 Gram of a nearly
    degenerate model can lose positive definiteness), the float64 Gram's
    solve is taken instead. Both are computed and one is selected on the
    device, so the step never reads a value back to decide (the
    reference branches with ``lax.cond``)."""
    return _gls_core_blocks([(M, F, r, nvec, valid)], phi, jvar,
                            None if seg is None else [seg], f32mm)


def _gls_core_blocks(blocks, phi, jvar, segs=None, f32mm=False):
    """``_gls_core`` over row blocks of the TOA axis: ``blocks`` the
    (M, F, r, nvec, valid) of each block in order, each on its own
    device, ``segs`` their segment plans over the global epoch ids (an
    epoch may straddle two blocks). Every sum over rows is a per-block
    partial reduced in block order on the first block's device, where
    phi, jvar and the outputs live: the column scales before any block
    is scaled (``gls.equilibrate_blocks``), the Grams, rCr and the
    segment sums before g = jvar / (1 + jvar s) is formed. With
    ``f32mm`` each block's Gram is a float32 product and the partials are
    summed in float64 (``_symm_mm`` returns float64). One block runs
    exactly the ops of the one-device solve."""
    M0 = blocks[0][0]
    p = M0.shape[1]
    q = blocks[0][1].shape[1]
    mdt = M0.dtype
    with obs.span("fit_step.gram"):
        ws = [valid / nvec for _, _, _, nvec, valid in blocks]
        Mns, colmax, norm = equilibrate_blocks(
            [b[0] for b in blocks], [w.to(mdt) for w in ws])
        bigs, bigss, rss = [], [], []
        for (_, F, r, _, _), Mn, w in zip(blocks, Mns, ws):
            big = torch.cat([Mn, F.to(mdt)], dim=1)
            # symmetric sqrt(w) split: Sigma is exactly symmetric
            sw = torch.sqrt(w)
            bigs.append(big)
            bigss.append(big * sw.to(mdt)[:, None])
            rss.append(r * sw)
        rCr = reduce_blocks([torch.sum(rs * rs) for rs in rss])
    if segs is not None:
        with obs.span("fit_step.ecorr_segments"):
            s_seg = reduce_blocks([sg_(w) for sg_, w in zip(segs, ws)])
            g = jvar / (1.0 + jvar * s_seg)
            E = reduce_blocks([sg_(big * w.to(mdt)[:, None])
                               for sg_, big, w in zip(segs, bigs, ws)])
            wr_seg = reduce_blocks([sg_(w * b[2])
                                    for sg_, w, b in zip(segs, ws,
                                                         blocks)])
            sg = torch.sqrt(g)
            Eg = E * sg.to(mdt)[:, None]

    def assemble(use32):
        with obs.span("fit_step.gram"):
            Sigma = reduce_blocks([_gls._symm_mm(x, x, use32)
                                   for x in bigss])
            b = reduce_blocks([_gls._symm_mm(x, rs.to(mdt), use32)
                               for x, rs in zip(bigss, rss)])
        rcr = rCr
        if segs is not None:
            with obs.span("fit_step.ecorr_segments"):
                Sigma = Sigma - _gls._symm_mm(Eg, Eg, use32)
                b = b - Eg.to(torch.float64).T @ (sg * wr_seg)
                rcr = rCr - torch.sum(g * wr_seg ** 2)
        return Sigma, b, rcr

    def solve(Sigma, b, rcr):
        with obs.span("fit_step.cholesky_solves"):
            zeros = torch.zeros(p, dtype=torch.float64, device=M0.device)
            Sigma = Sigma + torch.diag(torch.cat([zeros, 1.0 / phi]) if q
                                       else zeros)
            # Jacobi-precondition to unit diagonal: Sigma mixes O(1)
            # data terms with 1/phi priors up to ~1e25
            d = jacobi(Sigma)
            dd = torch.outer(d, d)
            L = cho_factor(Sigma / dd)
            xhat = cho_solve(L, b / d) / d
            eye = torch.eye(p + q, dtype=torch.float64, device=M0.device)
            inv = cho_solve(L, eye) / dd
            # chi2 at the point: marginalize the noise (F-basis + ECORR)
            # only, not the parameter block
            if q:
                bF, dF = b[p:], d[p:]
                LF = cho_factor(Sigma[p:, p:] / torch.outer(dF, dF))
                chi2 = rcr - bF @ (cho_solve(LF, bF / dF) / dF)
            else:
                chi2 = rcr
        return xhat, inv, chi2

    xhat, inv, chi2 = solve(*assemble(f32mm))
    if f32mm:
        ok = (torch.all(torch.isfinite(xhat)) & torch.isfinite(chi2)
              & torch.all(torch.isfinite(inv))
              & torch.all(torch.diagonal(inv) >= 0.0))
        xhat64, inv64, chi264 = solve(*assemble(False))
        xhat = torch.where(ok, xhat, xhat64)
        inv = torch.where(ok, inv, inv64)
        chi2 = torch.where(ok, chi2, chi264)
    with obs.span("fit_step.cholesky_solves"):
        colmax, norm = colmax.to(torch.float64), norm.to(torch.float64)
        dparams = -xhat[:p] / colmax / norm  # r ≈ M(θ−θ_true): −x
        cov = inv[:p, :p] / torch.outer(colmax, colmax) \
            / torch.outer(norm, norm)
    return dparams, cov, chi2
