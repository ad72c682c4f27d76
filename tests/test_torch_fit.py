"""The GLS-fit slice of the port (pint_tpu_torch) against the reference
pint_tpu on the CPU: .tim ingestion, noise models, the design matrix
(torch.func.jacfwd, and the hybrid closed-form columns), simulated TOAs,
the fit step with ECORR segments, and the fitters, on
``__graft_entry__._flagship`` and on ``bench.build_problem``'s model cut
to 400 TOAs and 4 DMX windows.

The port's delay chain is the reference's op for op, but XLA's fused CPU
code, and the trigonometric functions of the two libraries, round some
delays 1 ulp (~3e-14 s) apart. Where a test needs the phase to the last
bit (simulated TOAs) the reference runs under ``jax.disable_jit()``;
elsewhere a chi2 is held to its relative tolerance plus the change that
the measured residual difference alone explains (``chi2_tol``)."""

import io
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import bench
from __graft_entry__ import _flagship

from pint_tpu.fitter import DownhillWLSFitter as RDownhillWLS
from pint_tpu.fitter import WLSFitter as RWLS
from pint_tpu.gls import DownhillGLSFitter as RDownhillGLS
from pint_tpu.models import get_model as r_get_model
from pint_tpu.parallel import build_fit_step as r_build_fit_step
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake
from pint_tpu.toa import get_TOAs as r_get_TOAs
from pint_tpu.toa import merge_TOAs as r_merge

from pint_tpu_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
from pint_tpu_torch.gls import DownhillGLSFitter, GLSFitter, _gls_kernel, \
    gls_chi2
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import fit_args_from_numpy, \
    toas_from_columns
from pint_tpu_torch.ops.dd import DD, dd_frac
from pint_tpu_torch.parallel import build_fit_step
from pint_tpu_torch.parallel.fit_step import SegmentSum
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
from pint_tpu_torch.toa import get_TOAs, merge_TOAs

from test_torch_photon import _assert_batches_bitwise, _quiet

CPU = "cpu"
NGC_PAR = "tests/datafile/NGC6440E.par"
NGC_TIM = "tests/datafile/NGC6440E.tim"

# the tolerances chip_smoke.py holds the GPU step to against the CPU
DP_SIGMA, COV_REL, CHI2_REL, RESID_S = 1e-6, 1e-8, 1e-10, 1e-12


def chi2_tol(chi2, dr, sigma, rel):
    """How far two chi2 = r^T C^-1 r may differ when their residual
    vectors differ by ``dr``: ``rel`` of chi2 for the arithmetic, plus
    what dr itself moves (C >= diag(sigma^2), so by Cauchy-Schwarz
    |chi2(r + dr) - chi2(r)| <= 2 sqrt(chi2) |dr/sigma| + |dr/sigma|^2).
    Where sin/cos/log of the two libraries round 1 ulp apart, a delay
    and its residual differ by ~3e-14 s, which moves a chi2 of a few
    hundred by ~1e-10 of itself."""
    d = float(np.linalg.norm(np.asarray(dr) / np.asarray(sigma)))
    return rel * abs(chi2) + 2.0 * np.sqrt(abs(chi2)) * d + d * d


def _reduced_problem():
    """bench.build_problem()'s model and TOAs at 400 TOAs, 4 DMX."""
    saved = bench.NTOA, bench.NDMX
    bench.NTOA, bench.NDMX = 400, 4
    try:
        return bench.build_problem()
    finally:
        bench.NTOA, bench.NDMX = saved


@pytest.fixture(scope="module", params=["flagship", "problem"])
def problem(request):
    """(reference model, reference TOAs, port model, port TOAs): the port
    model from the reference's par output, the port TOAs holding the
    reference TOAs' host columns."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm, rt = (_flagship(ntoa=64, ndmx=4) if request.param == "flagship"
                  else _reduced_problem())
        tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    return rm, rt, tm, toas_from_columns(rt, CPU)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------- model


def test_model_components_and_packed_params_match(problem):
    rm, _, tm, _ = problem
    assert sorted(tm.components) == sorted(rm.components)
    rp, tp = rm._pack(), tm._pack()
    assert rp[:2] == tp[:2]
    for a, b in zip(rp[2:], tp[2:]):
        assert _same(a, b)
    assert tm.linear_design_names() == rm.linear_design_names()


def test_noise_model_bitwise(problem):
    rm, rt, tm, tt = problem
    assert _same(rm.scaled_toa_uncertainty(rt),
                 tm.scaled_toa_uncertainty(tt))
    assert _same(rm.noise_model_designmatrix(rt),
                 tm.noise_model_designmatrix(tt))
    assert _same(rm.noise_model_basis_weight(rt),
                 tm.noise_model_basis_weight(tt))
    rs, ts = rm.noise_model_ecorr_segments(rt), \
        tm.noise_model_ecorr_segments(tt)
    assert all(_same(a, b) for a, b in zip(rs[:2], ts[:2]))
    assert rs[2] == ts[2] == ("EcorrNoise",)
    assert rm.noise_model_dimensions(rt) == tm.noise_model_dimensions(tt)


def test_designmatrix_matches_reference(problem):
    rm, rt, tm, tt = problem
    Mr, nr, ur = rm.designmatrix(rt)
    Mt, nt, ut = tm.designmatrix(tt)
    assert nr == nt and ur == ut
    assert Mt.dtype == torch.float64
    Mr = np.asarray(Mr)
    err = np.abs(Mr - _np(Mt)) / np.max(np.abs(Mr), axis=0)
    assert np.max(err) <= 1e-12, np.max(err)


def test_hybrid_columns_match_pure_ad(problem):
    """Every closed-form column equals the jacfwd column to rounding,
    TZR-row subtraction included (tests/test_hybrid_jac.py's rule)."""
    _, _, m, toas = problem
    phase_fn, (free, frozen) = m._build_phase_fn()
    cache = m.get_cache(toas, CPU)
    th, tl, fh, fl = (torch.as_tensor(x, dtype=torch.float64)
                      for x in m._pack()[2:])

    def phase_f64(thx):
        ph, _ = phase_fn(thx, tl, fh, fl, cache["batch"], cache)
        f = dd_frac(ph)
        return f.hi + f.lo

    jacfull = torch.func.jacfwd(phase_f64)(th).numpy()
    pv = {nm: DD(th[i], tl[i]) for i, nm in enumerate(free)}
    pv.update({nm: DD(fh[j], fl[j]) for j, nm in enumerate(frozen)})
    lin = m.linear_design_names()
    assert lin
    cols = m.linear_design_columns(pv, cache["batch"], cache, lin)
    assert set(cols) == lin
    for nm in sorted(lin):
        a, b = cols[nm].numpy(), jacfull[:, free.index(nm)]
        scale = max(np.max(np.abs(b)), 1e-300)
        assert (np.max(np.abs(a - b)) / scale < 1e-12
                or np.max(np.abs(a - b)) < 1e-13), nm
    # and the hybrid design Jacobian equals the all-AD one
    hyb = m.design_jacobian(th, tl, fh, fl, cache["batch"], cache,
                            hybrid=True).numpy()
    ad = m.design_jacobian(th, tl, fh, fl, cache["batch"], cache).numpy()
    err = np.abs(hyb - ad) / np.maximum(np.max(np.abs(ad), axis=0), 1e-300)
    assert np.max(err) < 1e-12


# ---------------------------------------------------------------- TOAs


def test_tim_toas_and_merge_bitwise():
    rt = _quiet(r_get_TOAs, NGC_TIM)
    tt = _quiet(get_TOAs, NGC_TIM, device=CPU)
    assert tt.ntoas == rt.ntoas == 62
    assert tt.flags == rt.flags and tt.obs == rt.obs
    _assert_batches_bitwise(rt.to_batch(), tt.to_batch())
    rmg = r_merge([rt.select(np.arange(0, 62, 2)),
                   rt.select(np.arange(1, 62, 2))])
    tmg = merge_TOAs([toas_from_columns(rt.select(np.arange(0, 62, 2)),
                                        CPU),
                      toas_from_columns(rt.select(np.arange(1, 62, 2)),
                                        CPU)])
    _assert_batches_bitwise(rmg.to_batch(), tmg.to_batch())


def test_simulated_toas_bitwise():
    """Same par, MJDs and seed: the port's simulated TOAs (Newton steps
    onto integer phase, then a white and a correlated draw from the
    caller's generator) are bitwise the reference's."""
    rm, _ = _flagship(ntoa=16, ndmx=2)
    tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    mjds = np.linspace(54100.0, 55900.0, 12)
    kw = dict(error_us=1.5, freq_mhz=np.tile([1400.0, 820.0], 6),
              add_noise=True, add_correlated_noise=True,
              flags={"be": "X"})
    with jax.disable_jit():
        rt = _quiet(r_fake, mjds, rm, rng=np.random.default_rng(5), **kw)
    tt = _quiet(make_fake_toas_fromMJDs, mjds, tm,
                rng=np.random.default_rng(5), **kw)
    assert _same(rt.mjd_frac[0], tt.mjd_frac[0])
    assert _same(rt.mjd_frac[1], tt.mjd_frac[1])
    _assert_batches_bitwise(rt.to_batch(), tt.to_batch())


# ------------------------------------------------------------ fit step


def _check_step(ref, got, nvec, what=""):
    dp, cov, chi2, r = (_np(x) for x in got)
    rdp, rcov, rchi2, rr = (np.asarray(x) for x in ref)
    sig = np.sqrt(np.diag(rcov))
    assert np.max(np.abs(dp - rdp) / sig) <= DP_SIGMA, what
    assert np.max(np.abs(np.diag(cov) - np.diag(rcov))
                  / np.diag(rcov)) <= COV_REL, what
    assert abs(float(chi2) - float(rchi2)) <= chi2_tol(
        float(rchi2), r - rr, np.sqrt(nvec), CHI2_REL), what
    assert np.max(np.abs(r - rr)) <= RESID_S, what


def test_step_matches_reference(problem):
    """step_fn fed the reference's converted build_fit_step arguments,
    and the port's own build_fit_step, against the reference step."""
    rm, rt, tm, tt = problem
    rstep, rargs, rnames = r_build_fit_step(rm, rt)
    ref = jax.jit(rstep)(*rargs)
    step, args, names = build_fit_step(tm, tt, device=CPU)
    assert names == rnames
    assert len(args) == 12 and args[10].dtype == torch.int64
    nvec = np.asarray(rargs[8])
    _check_step(ref, step(*fit_args_from_numpy(rargs, CPU)), nvec,
                "converted")
    _check_step(ref, step(*args), nvec, "own args")


def test_hybrid_step_matches_reference(problem):
    """The hybrid Jacobian split (the reference's default, an option of
    the port's step) on both sides."""
    rm, rt, tm, tt = problem
    rstep, rargs, rnames = r_build_fit_step(rm, rt, hybrid_jac=True)
    ref = jax.jit(rstep)(*rargs)
    step, args, names = build_fit_step(tm, tt, device=CPU, hybrid_jac=True)
    assert names == rnames
    _check_step(ref, step(*args), np.asarray(rargs[8]), "hybrid")


def test_step_repeats_bitwise_and_segments_match_dense(problem):
    """Two calls give bitwise-equal outputs; the ECORR segment path
    agrees with the dense quantization-basis solve, its chi2 with the
    dense marginalized chi2 (tests/test_fit_step_ecorr.py)."""
    _, _, m, toas = problem
    step, args, names = build_fit_step(m, toas, device=CPU)
    a, b = step(*args), step(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    dp, cov, chi2, r_step = a
    r = Residuals(toas, m).time_resids
    M, names_d, _ = m.designmatrix(toas)
    nvec, F, phi = m.noise_device(toas)
    assert names_d == names
    assert F.shape[1] == args[6].shape[1] + (args[11].shape[0] - 1)
    x, cov_d, _, _, _, ok = _gls_kernel(M, F, phi, r, nvec)
    assert bool(ok)
    # [1:]: Residuals removes the mean weighted by the raw TOA errors,
    # the step by the EFAC/EQUAD-scaled ones; the Offset absorbs that
    np.testing.assert_allclose(dp.numpy()[1:], -x.numpy()[1:], rtol=1e-6,
                               atol=1e-16)
    np.testing.assert_allclose(cov.numpy(), cov_d.numpy(), rtol=1e-5,
                               atol=1e-30)
    # the segment chi2 is the dense-basis marginalized chi2 of the same
    # residuals
    assert float(chi2) == pytest.approx(gls_chi2(m, toas, resids=r_step),
                                        rel=1e-8)


def test_segment_sum_is_a_fixed_order_bincount():
    rng = np.random.default_rng(3)
    nseg = 9
    # unsorted ids, a crowded last ('no epoch') slot and an empty slot
    eid = rng.choice([0, 1, 2, 3, 5, 6, 7, 8, 8, 8, 8], 300)
    x = rng.standard_normal((300, 4))
    plan = SegmentSum(torch.as_tensor(eid), nseg)
    got = plan(torch.as_tensor(x)).numpy()
    want = np.stack([np.bincount(eid, weights=x[:, j], minlength=nseg)
                     for j in range(4)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert got[4].tolist() == [0.0] * 4


def test_failed_cholesky_flags_and_falls_back():
    """A singular normal matrix gives NaN, not an exception, and ok
    False; GLSFitter then takes the eigh solve with a warning."""
    rng = np.random.default_rng(4)
    M = torch.as_tensor(rng.standard_normal((40, 3)))
    M = torch.cat([M, M[:, :1]], dim=1)  # exactly collinear column
    F = torch.as_tensor(rng.standard_normal((40, 2)))
    phi = torch.ones(2, dtype=torch.float64)
    r = torch.as_tensor(rng.standard_normal(40))
    nvec = torch.ones(40, dtype=torch.float64)
    *_, ok = _gls_kernel(M, F, phi, r, nvec)
    assert not bool(ok)


# ------------------------------------------------------------- fitters


def _ngc():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm, rt = r_get_model(NGC_PAR), r_get_TOAs(NGC_TIM)
        tm, tt = get_model(NGC_PAR, device=CPU), get_TOAs(NGC_TIM,
                                                          device=CPU)
    return rm, rt, tm, tt


def _fit_pair(rcls, tcls, rm, rt, tm, tt, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rf, tf = rcls(rt, rm), tcls(tt, tm)
        return rf, tf, rf.fit_toas(**kw), tf.fit_toas(**kw)


def _check_fit(rf, tf, rchi2, tchi2):
    """The same optimum: parameters within 1e-6 sigma, chi2 within 1e-9
    relative plus what the final residuals' difference moves it by."""
    dr = tf.resids.time_resids.numpy() - np.asarray(rf.resids.time_resids)
    sigma = rf.model.scaled_toa_uncertainty(rf.toas)
    assert np.max(np.abs(dr)) <= 1e-10
    assert abs(tchi2 - rchi2) <= chi2_tol(rchi2, dr, sigma, 1e-9), \
        (tchi2, rchi2)
    assert tf.model.free_params == rf.model.free_params
    for nm in rf.model.free_params:
        rp, tp = rf.model.get_param(nm), tf.model.get_param(nm)
        assert abs(tp.value - rp.value) <= 1e-6 * rp.uncertainty, nm
        assert tp.uncertainty == pytest.approx(rp.uncertainty, rel=1e-6)


def test_downhill_gls_reaches_reference_optimum(problem):
    rm, rt, _, tt = problem
    tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    rm = r_get_model(io.StringIO(rm.as_parfile()))
    rf, tf, rchi2, tchi2 = _fit_pair(RDownhillGLS, DownhillGLSFitter, rm,
                                     rt, tm, tt)
    assert tf.converged and tf.stats.iterations == rf.stats.iterations
    _check_fit(rf, tf, rchi2, tchi2)
    assert tf.noise_resids.shape == (tt.ntoas,)


@pytest.mark.parametrize("kind", ["wls", "downhill_wls"])
def test_wls_on_tim_reaches_reference_optimum(kind):
    rcls, tcls = {"wls": (RWLS, WLSFitter),
                  "downhill_wls": (RDownhillWLS, DownhillWLSFitter)}[kind]
    _check_fit(*_fit_pair(rcls, tcls, *_ngc()))


def test_fitter_auto_routes_and_refuses_unported(problem):
    _, _, tm, tt = problem
    assert type(Fitter.auto(tt, tm)) is DownhillGLSFitter
    assert type(Fitter.auto(tt, tm, downhill=False)) is GLSFitter
    _, _, nm, nt = _ngc()
    assert type(Fitter.auto(nt, nm)) is DownhillWLSFitter
    for kw in (dict(streaming=True), dict(device=True),
               dict(serve=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Fitter.auto(tt, tm, **kw)


def test_pintempo_cli_matches_reference(tmp_path, capsys):
    from pint_tpu.scripts.pintempo import main as r_main
    from pint_tpu_torch.scripts.pintempo import main as t_main

    out = {}
    for tag, main, extra in (("ref", r_main, []),
                             ("port", t_main, ["--device", "cpu"])):
        par = tmp_path / f"{tag}.par"
        assert _quiet(main, [NGC_PAR, NGC_TIM, "--outfile", str(par),
                             *extra]) == 0
        text = capsys.readouterr().out
        out[tag] = (float(re.search(r"chi2: (\S+)", text).group(1)),
                    _quiet(r_get_model, str(par)))
    assert out["port"][0] == pytest.approx(out["ref"][0], rel=1e-6)
    rmod, tmod = out["ref"][1], out["port"][1]
    rm, rt, _, _ = _ngc()
    rf = RDownhillWLS(rt, rm)
    _quiet(rf.fit_toas)
    for nm in rmod.free_params:
        rp, tp = rmod.get_param(nm), tmod.get_param(nm)
        assert abs(tp.value - rp.value) <= 1e-6 * rf.errors[nm], nm
