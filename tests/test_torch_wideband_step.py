"""The one-function wideband fit step of the port
(``build_fit_step(model, toas, wideband=True)``: the stacked [time; DM]
GLS iteration) against the reference's ``build_fit_step(wideband=True,
anchored=False, jac_f32=False, matmul_f32=False)`` on the CPU, with the
hybrid Jacobian split off on both sides and then on on both sides, on
test_torch_wideband.py's isolated-pulsar and config-3 (ELL1) fixtures.

The reference's phase chain runs eagerly (``jax.disable_jit()``): compiled, XLA
rounds some delays 1 ulp (~3e-14 s) away from the eager chain, and a
binary's phase ~1e-6 turns (test_torch_binary.py). Eager, the isolated
pulsar's step is the port's to ~1e-15 relative, and its dparams are
held to 1e-9 sigma and its chi2 to 1e-10 relative as they are. The
binary's residuals still differ by ~1 ulp of its delays (torch's and
XLA's sin and cos), which moves dparams by ~5e-9 sigma and chi2 by
~1e-10 relative through the step's own linear algebra: there the same
limits hold the part of each difference that the residual difference
does not explain, and the raw differences are held to the fit path's
limits. On both, cov is held to 1e-10 relative and the time residuals
to 1e-12 s as they are."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu.parallel import build_fit_parts as r_build_fit_parts
from pint_tpu.parallel import build_fit_step as r_build_fit_step
from pint_tpu.parallel.fit_step import _gls_core as r_gls_core

import pint_tpu_torch.parallel.fit_step as fit_step
from pint_tpu_torch.models.convert import fit_args_from_numpy
from pint_tpu_torch.parallel import build_fit_parts, build_fit_step
from pint_tpu_torch.parallel.fit_step import SegmentSum, _gls_core

from test_torch_wideband import CPU, NTOA, _np, wideband_problem

DP_SIGMA, COV_REL, CHI2_REL, RESID_S = 1e-9, 1e-10, 1e-10, 1e-12
DP_RAW, CHI2_RAW = 1e-6, 1e-8  # the fit path's raw limits (test_torch_fit)
REF_FLAGS = dict(wideband=True, anchored=False, jac_f32=False,
                 matmul_f32=False)

_REF: dict = {}


def _reference(name, hybrid):
    """The reference step's outputs and arguments, once per module: its
    ``parts_fn`` (the phase chain, residuals, Jacobians and stacking) run
    eagerly, then its step's weighted-mean subtraction and ``_gls_core``
    compiled, as its ``step_fn`` chains them (eager, the solve alone
    takes ~10 s)."""
    key = (name, hybrid)
    if key not in _REF:
        rm, rt, _, _ = wideband_problem(name)
        rparts, rargs, rnames, meta = r_build_fit_parts(
            rm, rt, hybrid_jac=hybrid, **REF_FLAGS)
        with jax.disable_jit():
            parts = rparts(*rargs)
        assert meta["incoffset"] and not meta["jac32"]

        @jax.jit
        def solve(M, Fv, r0, nvec, valid, eid, tmask, phi, jvar):
            wt = tmask / nvec
            r = r0 - (jnp.sum(r0 * wt) / jnp.sum(wt)) * tmask
            dp, cov, chi2, _ = r_gls_core(M, Fv, phi, r, nvec, valid, eid,
                                          jvar, meta["nseg"], f32mm=False)
            return dp, cov, chi2, r[:rt.ntoas]

        out = [np.asarray(x) for x in solve(*parts, rargs[7], rargs[11])]
        _REF[key] = (out, rargs, rnames)
    return _REF[key]


def _explained(parts_fn, args, r_ref_time):
    """(dparams, chi2) of the port's step, and the same two with its time
    residuals replaced by the reference's, from the port's own stacked
    rows: the step's response to the residual difference alone."""
    M, Fv, r0, nvec, valid, eid, tmask = parts_fn(*args)
    wt = tmask / nvec
    r = r0 - (torch.sum(r0 * wt) / torch.sum(wt)) * tmask
    n = r_ref_time.shape[0]
    r_ref = torch.cat([torch.as_tensor(r_ref_time), r[n:]])
    jvar = args[11]
    plan = SegmentSum(eid, jvar.shape[0]) if jvar.shape[0] > 1 else None
    dp, _, chi2 = _gls_core(M, Fv, args[7], r, nvec, valid, jvar, plan)
    dp_ref, _, chi2_ref = _gls_core(M, Fv, args[7], r_ref, nvec, valid,
                                    jvar, plan)
    return dp - dp_ref, float(chi2 - chi2_ref)


@pytest.mark.parametrize("hybrid", [False, True], ids=["jacfwd", "hybrid"])
@pytest.mark.parametrize("name", ["isolated", "ell1"])
def test_wideband_step_matches_reference(name, hybrid):
    ref, rargs, rnames = _reference(name, hybrid)
    _, _, tm, tt = wideband_problem(name)
    step, args, names = build_fit_step(tm, tt, device=CPU,
                                       hybrid_jac=hybrid, wideband=True)
    assert names == rnames
    dp, cov, chi2, r = (_np(x) for x in step(*args))
    rdp, rcov, rchi2, rr = ref
    assert r.shape == rr.shape == (NTOA,)
    sig = np.sqrt(np.diag(rcov))
    if name == "isolated":
        dp_moved, chi2_moved = np.zeros_like(dp), 0.0
    else:
        # the part of each difference that the binary's 1-ulp residual
        # difference explains
        parts_fn, pargs, _, _ = build_fit_parts(
            tm, tt, device=CPU, hybrid_jac=hybrid, wideband=True)
        dp_moved, chi2_moved = _explained(parts_fn, pargs, rr)
        dp_moved = _np(dp_moved)
        assert np.max(np.abs(dp - rdp) / sig) <= DP_RAW
        assert abs(float(chi2) - float(rchi2)) <= \
            CHI2_RAW * abs(float(rchi2))
    assert np.max(np.abs(dp - rdp - dp_moved) / sig) <= DP_SIGMA
    assert abs(float(chi2) - float(rchi2) - chi2_moved) <= \
        CHI2_REL * abs(float(rchi2))
    assert np.max(np.abs(np.diag(cov) - np.diag(rcov)) / np.diag(rcov)) \
        <= COV_REL
    assert np.max(np.abs(r - rr)) <= RESID_S
    # the reference's own arguments, carried across, give the same step
    conv = step(*fit_args_from_numpy(rargs, CPU))
    for a, b in zip(conv, (dp, cov, chi2, r)):
        np.testing.assert_allclose(_np(a), b, rtol=1e-12, atol=1e-300)


def test_reference_step_is_its_parts_then_its_solve():
    """The composition ``_reference`` takes as the reference step is the
    reference's build_fit_step: its compiled step agrees with it to the
    fit path's limits (compiled, its delays round 1 ulp apart)."""
    ref, rargs, _ = _reference("isolated", False)
    rm, rt, _, _ = wideband_problem("isolated")
    rstep, sargs, _ = r_build_fit_step(rm, rt, **REF_FLAGS)
    dp, cov, chi2, r = (np.asarray(x) for x in jax.jit(rstep)(*sargs))
    sig = np.sqrt(np.diag(ref[1]))
    assert np.max(np.abs(dp - ref[0]) / sig) <= DP_RAW
    assert np.max(np.abs(np.diag(cov) - np.diag(ref[1]))
                  / np.diag(ref[1])) <= 1e-8
    assert float(chi2) == pytest.approx(float(ref[2]), rel=CHI2_RAW)
    assert np.max(np.abs(r - ref[3])) <= RESID_S


def test_wideband_parts_stack_time_over_dm_rows():
    """build_fit_parts(wideband=True) against the reference's parts (run
    eagerly): 2N stacked rows, DM rows' Offset column zero, tmask zero
    on the DM rows, the DM rows in ECORR's 'no epoch' slot, the
    DM-channel noise block below the time one."""
    rm, rt, tm, tt = wideband_problem("isolated")
    parts_fn, args, names, meta = build_fit_parts(tm, tt, device=CPU,
                                                  wideband=True)
    assert meta["wideband"] and meta["nseg"] > 1
    M, Fv, r0, nvec, valid, eid, tmask = (_np(x) for x in parts_fn(*args))
    rparts, rargs, rnames, _ = r_build_fit_parts(rm, rt, **REF_FLAGS)
    with jax.disable_jit():
        ref = [np.asarray(x) for x in rparts(*rargs)]
    assert names == rnames
    n, q = NTOA, args[6].shape[1]
    assert M.shape == (2 * n, len(names)) and Fv.shape == (2 * n, q) and q
    assert np.all(M[n:, 0] == 0.0) and np.all(tmask[n:] == 0.0)
    assert np.all(tmask[:n] == 1.0) and np.all(valid == 1.0)
    assert np.all(eid[n:] == meta["nseg"] - 1)
    assert np.array_equal(Fv[n:], _np(args[5]["wb_Fdm"]))
    assert np.any(Fv[n:] != 0.0) and np.any(M[n:, 1:] != 0.0)
    for got, want in zip((M, Fv, r0, nvec, valid, eid, tmask), ref):
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(want)))


def test_wideband_step_repeats_and_builds_its_segment_plan_once(monkeypatch):
    """Two steps are bitwise equal; the stacked ECORR plan (a host sort of
    the epoch ids) is made when the step is built, never by a step, and
    once for epoch ids of the caller's own."""
    _, rt, tm, tt = wideband_problem("isolated")
    step, args, _ = build_fit_step(tm, tt, device=CPU, wideband=True)
    made = []

    class Counting(SegmentSum):
        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(fit_step, "SegmentSum", Counting)
    a, b = step(*args), step(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert made == []
    own = list(args)
    own[10] = args[10].clone()
    c, d = step(*own), step(*own)
    assert len(made) == 1 and made[0][0].shape == (2 * NTOA,)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(torch.equal(x, y) for x, y in zip(c, d))


def test_hybrid_dm_rows_equal_the_full_jacobian():
    """The DM rows, with hybrid_jac off and on, take tangents of the
    DM-affecting parameters only: they are the negated full jacfwd of the
    model DM over every free parameter, bitwise, and the columns left
    out are exactly zero."""
    _, _, tm, tt = wideband_problem("ell1")
    dm_fn, (free, th) = tm.build_dm_fn(tt, CPU)
    full = -_np(torch.func.jacfwd(dm_fn)(th))
    dm_set = tm.dm_affecting_free_params()
    assert 0 < len(dm_set & set(free)) < len(free)
    for j, nm in enumerate(free):
        if nm not in dm_set:
            assert not np.any(full[:, j]), nm
    for hybrid in (False, True):
        parts_fn, args, names, _ = build_fit_parts(
            tm, tt, device=CPU, hybrid_jac=hybrid, wideband=True)
        rows = _np(parts_fn(*args)[0])[NTOA:]
        assert names == ["Offset"] + free
        assert not np.any(rows[:, 0])
        assert np.array_equal(rows[:, 1:], full)
