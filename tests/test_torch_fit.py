"""The GLS-fit slice of the port (pint_tpu_torch) against the reference
pint_tpu on the CPU: .tim ingestion, noise models, the design matrix
(torch.func.jacfwd, and the hybrid closed-form columns), simulated TOAs,
the fit step with ECORR segments, the fitters and the dense
full-covariance solve, on ``__graft_entry__._flagship``, on
``bench.build_problem``'s model cut to 400 TOAs and 4 DMX windows, and
(the step, hybrid step and downhill tests) on the B1855+09-like ELL1
binary of ``bench.config2_b1855like`` cut to 200 TOAs and 4 DMX windows.

The port's delay chain is the reference's op for op, but XLA's fused CPU
code, and the trigonometric functions of the two libraries, round some
delays 1 ulp (~3e-14 s) apart. Where a test needs the phase to the last
bit (simulated TOAs) the reference runs under ``jax.disable_jit()``;
elsewhere a chi2 is held to its relative tolerance plus the change that
the measured residual difference alone explains (``chi2_tol``). The
reference's compiled CPU code of a binary model rounds its double-double
phase ~1e-6 turns away from exact (test_torch_binary.py), so on the
binary fixture the reference always runs eagerly."""

import contextlib

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
from pint_tpu.gls import GLSFitter as RGLS
from pint_tpu.gls import _gls_kernel_fullcov as r_fullcov
from pint_tpu.models import get_model as r_get_model
from pint_tpu.parallel import build_fit_step as r_build_fit_step
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake
from pint_tpu.toa import get_TOAs as r_get_TOAs
from pint_tpu.toa import merge_TOAs as r_merge

from pint_tpu_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
from pint_tpu_torch.gls import DeviceDownhillGLSFitter, DownhillGLSFitter, \
    GLSFitter, StreamingGLSFitter, _gls_kernel, _gls_kernel_fullcov, \
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


def _b1855_problem(ntoa=200, ndmx=4):
    """bench.config2_b1855like()'s model and TOAs (B1855+09-like ELL1
    binary, EFAC/EQUAD/ECORR, 20 red-noise modes, clustered TOAs at
    1400/430 MHz, seed 2) at ``ntoa`` TOAs and ``ndmx`` DMX windows."""
    span0, span1 = 53000.0, 56000.0
    par = [
        "PSR B1855+09x", "RAJ 18:57:36.39 1", "DECJ 09:43:17.2 1",
        "PMRA -2.9 1", "PMDEC -5.5 1", "PX 0.3 1",
        "F0 186.49408156698235 1", "F1 -6.2049e-16 1",
        "DM 13.29", "PEPOCH 54500", "POSEPOCH 54500", "DMEPOCH 54500",
        "TZRMJD 54500.1", "TZRSITE @", "TZRFRQ 1400", "UNITS TDB",
        "BINARY ELL1", "PB 12.32717 1", "A1 9.2307805 1",
        "TASC 54500.03 1", "EPS1 -2.15e-5 1", "EPS2 -3.1e-7 1",
        "SINI 0.999 1", "M2 0.25 1",
        "EFAC -be X 1.1", "EQUAD -be X 0.2", "ECORR -be X 0.9",
        "TNREDAMP -14.1", "TNREDGAM 4.1", "TNREDC 20",
    ]
    bench._add_dmx(par, span0, span1, ndmx)
    mjds = bench._clustered_mjds(span0, span1, ntoa)
    freqs = np.tile([1400.0, 1400.0, 430.0, 430.0], ntoa // 4)
    return bench._make_model_toas(par, mjds, freqs, seed=2,
                                  flag_sets={"be": lambda i: "X"})


_BUILDERS = {"flagship": lambda: _flagship(ntoa=64, ndmx=4),
             "problem": _reduced_problem, "b1855": _b1855_problem}
_BUILT: dict = {}


def _problem(name):
    """(reference model, reference TOAs, port model, port TOAs), built
    once per module: the port model from the reference's par output, the
    port TOAs holding the reference TOAs' host columns."""
    if name not in _BUILT:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rm, rt = _BUILDERS[name]()
            tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
        _BUILT[name] = (rm, rt, tm, toas_from_columns(rt, CPU))
    return _BUILT[name]


def _reference_mode(name):
    """How the reference runs on a fixture: eagerly on the binary one
    (see the module docstring), compiled otherwise."""
    return jax.disable_jit() if name == "b1855" else contextlib.nullcontext()


@pytest.fixture(scope="module", params=["flagship", "problem"])
def problem(request):
    return _problem(request.param)


@pytest.fixture(scope="module", params=["flagship", "problem", "b1855"])
def fit_problem(request):
    """``problem``'s cases and the binary one, with the reference's
    evaluation mode."""
    return _problem(request.param) + (request.param,)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------- model


def test_model_components_and_packed_params_match(fit_problem):
    """The port model against the reference model; on the binary fixture
    against the reference rebuilt from the same par text, since the
    reference's as_parfile rounds the last bit of TASC's low word."""
    rm, _, tm, _, name = fit_problem
    if name == "b1855":
        rm = _quiet(r_get_model, io.StringIO(rm.as_parfile()))
    assert sorted(tm.components) == sorted(rm.components)
    rp, tp = rm._pack(), tm._pack()
    assert rp[:2] == tp[:2]
    for a, b in zip(rp[2:], tp[2:]):
        assert _same(a, b)
    assert tm.linear_design_names() == rm.linear_design_names()


def test_noise_model_bitwise(fit_problem):
    rm, rt, tm, tt, _ = fit_problem
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


def test_hybrid_columns_match_pure_ad(fit_problem):
    """Every closed-form column equals the jacfwd column to rounding,
    TZR-row subtraction included (tests/test_hybrid_jac.py's rule); on
    the binary fixture the stage sensitivity runs through the binary."""
    _, _, m, toas, _ = fit_problem
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


def _ref_step(name, rstep, rargs):
    with _reference_mode(name):
        return jax.jit(rstep)(*rargs)


def test_step_matches_reference(fit_problem):
    """step_fn fed the reference's converted build_fit_step arguments,
    and the port's own build_fit_step, against the reference step."""
    rm, rt, tm, tt, name = fit_problem
    rstep, rargs, rnames = r_build_fit_step(rm, rt)
    ref = _ref_step(name, rstep, rargs)
    step, args, names = build_fit_step(tm, tt, device=CPU)
    assert names == rnames
    assert len(args) == 12 and args[10].dtype == torch.int64
    nvec = np.asarray(rargs[8])
    _check_step(ref, step(*fit_args_from_numpy(rargs, CPU)), nvec,
                "converted")
    _check_step(ref, step(*args), nvec, "own args")


def test_hybrid_step_matches_reference(fit_problem):
    """The hybrid Jacobian split (the reference's default, an option of
    the port's step) on both sides."""
    rm, rt, tm, tt, name = fit_problem
    rstep, rargs, rnames = r_build_fit_step(rm, rt, hybrid_jac=True)
    ref = _ref_step(name, rstep, rargs)
    step, args, names = build_fit_step(tm, tt, device=CPU, hybrid_jac=True)
    assert names == rnames
    _check_step(ref, step(*args), np.asarray(rargs[8]), "hybrid")


def test_step_repeats_bitwise_and_segments_match_dense(fit_problem):
    """Two calls give bitwise-equal outputs; the ECORR segment path
    agrees with the dense quantization-basis solve, its chi2 with the
    dense marginalized chi2 (tests/test_fit_step_ecorr.py)."""
    _, _, m, toas, _ = fit_problem
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


def test_downhill_gls_reaches_reference_optimum(fit_problem):
    rm, rt, _, tt, name = fit_problem
    tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    rm = r_get_model(io.StringIO(rm.as_parfile()))
    with _reference_mode(name):
        rf, tf, rchi2, tchi2 = _fit_pair(RDownhillGLS, DownhillGLSFitter,
                                         rm, rt, tm, tt)
    assert tf.converged and tf.stats.iterations == rf.stats.iterations
    _check_fit(rf, tf, rchi2, tchi2)
    assert tf.noise_resids.shape == (tt.ntoas,)


def test_full_covariance_solve_matches_reference_and_woodbury():
    """The dense full-covariance solve against the reference's
    ``_gls_kernel_fullcov`` and against the port's basis-Woodbury
    ``_gls_kernel`` on the same inputs (the binary fixture's design
    matrix, residuals and dense noise basis), to the reference's limits
    (tests/test_gls.py: x rtol 1e-6 atol 1e-13, chi2 rtol 1e-6)."""
    _, _, m, toas = _problem("b1855")
    M, _, _ = m.designmatrix(toas)
    r = Residuals(toas, m).time_resids
    nvec, F, phi = m.noise_device(toas)
    x, cov, chi2, noise = _gls_kernel_fullcov(M, F, phi, r, nvec)
    rx, rcov, rchi2, rnoise = (np.asarray(v) for v in r_fullcov(
        *(jax.numpy.asarray(_np(v)) for v in (M, F, phi, r, nvec))))
    np.testing.assert_allclose(x.numpy(), rx, rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(float(chi2), float(rchi2), rtol=1e-6)
    np.testing.assert_allclose(np.diag(cov.numpy()), np.diag(rcov),
                               rtol=1e-6)
    np.testing.assert_allclose(noise.numpy(), rnoise, rtol=1e-6,
                               atol=1e-13)
    wx, _, wchi2, _, _, ok = _gls_kernel(M, F, phi, r, nvec)
    assert bool(ok)
    np.testing.assert_allclose(x.numpy(), wx.numpy(), rtol=1e-6, atol=1e-13)
    np.testing.assert_allclose(float(chi2), float(wchi2), rtol=1e-6)
    # a failed factorization gives NaN, not an exception
    bad = _gls_kernel_fullcov(M, F, phi, r, -nvec)
    assert not bool(torch.isfinite(bad[2]))


def test_full_cov_fitter_matches_reference(problem):
    """GLSFitter(full_cov=True): one fit step on both sides reaches the
    same point, and the Woodbury fitter's."""
    rm, rt, _, tt = problem
    par = rm.as_parfile()
    tm = get_model(io.StringIO(par), device=CPU)
    rm = r_get_model(io.StringIO(par))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rf, tf = RGLS(rt, rm, full_cov=True), GLSFitter(tt, tm, full_cov=True)
        rchi2, tchi2 = rf.fit_toas(), tf.fit_toas()
    _check_fit(rf, tf, rchi2, tchi2)
    assert tf.noise_resids.shape == (tt.ntoas,)
    wf = GLSFitter(tt, get_model(io.StringIO(par), device=CPU))
    wchi2 = _quiet(wf.fit_toas)
    assert wchi2 == pytest.approx(tchi2, rel=1e-6)
    for nm in tf.model.free_params:
        assert abs(wf.model.get_param(nm).value - tf.model.get_param(
            nm).value) <= 1e-6 * tf.errors[nm], nm


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
    assert type(Fitter.auto(tt, tm, streaming=True)) is StreamingGLSFitter
    assert type(Fitter.auto(tt, tm, device=True)) is DeviceDownhillGLSFitter
    from pint_tpu_torch.serve import ServeGLSFitter

    assert type(Fitter.auto(tt, tm, serve=object())) is ServeGLSFitter
    with pytest.raises(ValueError, match="exclusive"):
        Fitter.auto(tt, tm, serve=object(), device=True)


def test_pintempo_fits_a_binary(tmp_path, capsys):
    """The pintempo CLI on the binary fixture's par and its TOAs written
    as a .tim file: the output par keeps the BINARY line, and the
    port's fit of the orbit is the one DownhillGLSFitter reaches on the
    same TOAs, within 3 sigma of the simulated truth."""
    from pint_tpu_torch.scripts.pintempo import main as t_main

    rm, rt, _, _ = _problem("b1855")
    par, tim, out = (tmp_path / n for n in ("b.par", "b.tim", "post.par"))
    par.write_text(rm.as_parfile())
    rt.write_TOA_file(str(tim))
    assert _quiet(t_main, [str(par), str(tim), "--outfile", str(out),
                           "--device", "cpu"]) == 0
    assert "on cpu" in capsys.readouterr().out
    post = get_model(str(out), device=CPU)
    assert post.BINARY == "ELL1" and "BinaryELL1" in post.components
    tt = _quiet(get_TOAs, str(tim), device=CPU)
    tf = DownhillGLSFitter(tt, get_model(str(par), device=CPU))
    _quiet(tf.fit_toas)
    for nm in ("PB", "A1", "TASC", "EPS1", "EPS2", "SINI", "M2"):
        p, q = post.get_param(nm), tf.model.get_param(nm)
        assert abs(p.value - q.value) <= 1e-6 * q.uncertainty, nm
        assert abs(p.value - rm.get_param(nm).value) <= 3 * p.uncertainty


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
