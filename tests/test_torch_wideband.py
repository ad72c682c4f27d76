"""The wideband slice of the port (pint_tpu_torch.wideband,
.wideband_fitter, DispersionJump, ScaleDmError, PLDMNoise, FD, FDJump and
the DM channel of TimingModel) against the reference pint_tpu on the
CPU: the -pp_dm/-pp_dme flags, the model DM and its scaled
uncertainties, the DM-noise bases, the FD delays and columns, the DM
design matrix, the host fitters, ``Fitter.auto`` and ``pintempo``. The
one-function wideband step is in test_torch_wideband_step.py.

Two fixtures, each built once per module by the reference and carried
across (the port model from the reference's par output, the port TOAs
holding the reference TOAs' host columns):

- ``isolated``: tests/test_wideband_step.py's J1713-like isolated pulsar
  plus ECORR, PLDMNoise, a DMJUMP and a free FD1, at 200 TOAs in
  four-TOA epochs at 1400/2100 MHz, with DM measurements drawn around
  the reference model's DM (seed 3);
- ``ell1``: BASELINE config 3 (bench.config3_j1713like_wideband, a
  J1713+0747-like ELL1 binary with 10 DMX windows and DMEFAC/DMEQUAD)
  cut to 200 TOAs, its recipe otherwise unchanged.

The fitters run the reference compiled; their parameters are held to
1e-6 sigma and their chi2 to 1e-9 relative plus what the residual
difference explains (the jitted reference rounds some delays 1 ulp,
~3e-14 s, away from the port's eager chain; test_torch_fit.py)."""

import contextlib
import io
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import bench

from pint_tpu.fitter import Fitter as RFitter
from pint_tpu.models import get_model as r_get_model
from pint_tpu.residuals import Residuals as RResiduals
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake
from pint_tpu.toa import get_TOAs_array as r_get_TOAs_array
from pint_tpu.wideband import DMResiduals as RDMResiduals
from pint_tpu.wideband import WidebandTOAResiduals as RWBResiduals
from pint_tpu.wideband import get_wideband_dm as r_get_wideband_dm
from pint_tpu.wideband_fitter import WidebandDownhillFitter as RWBDownhill
from pint_tpu.wideband_fitter import WidebandTOAFitter as RWBFitter
from pint_tpu.wideband_fitter import build_dm_designmatrix as r_dm_design

from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.models.timing_model import make_pv
from pint_tpu_torch.residuals import DMResiduals as RexportDMResiduals
from pint_tpu_torch.toa import get_TOAs
from pint_tpu_torch.wideband import DMResiduals, WidebandTOAResiduals, \
    get_wideband_dm, has_wideband_dm
from pint_tpu_torch.wideband_fitter import WidebandDownhillFitter, \
    WidebandTOAFitter, build_dm_designmatrix

from test_torch_fit import chi2_tol
from test_torch_photon import _quiet

CPU = "cpu"
NTOA = 200

# tests/test_wideband_step.py:18 plus ECORR, PLDMNoise, DMJUMP and FD1
ISOLATED_PAR = """PSR J1713x
RAJ 17:13:49.53 1
DECJ 07:47:37.5 1
F0 218.81 1
F1 -4.08e-16 1
DM 15.99
PEPOCH 54500
TZRMJD 54500.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
DMX_0001 0.0 1
DMXR1_0001 53000
DMXR2_0001 54500
DMX_0002 0.0 1
DMXR1_0002 54500
DMXR2_0002 56000
DMEFAC -be X 1.1
DMEQUAD -be X 2e-5
ECORR -be X 0.5
TNDMAMP -13.5
TNDMGAM 3.0
TNDMC 10
DMJUMP -grp g1 0 1
FD1 1e-6 1
"""

# bench.config3_j1713like_wideband (bench.py:1175), copied
CONFIG3_PAR = [
    "PSR J1713+0747x", "RAJ 17:13:49.53 1", "DECJ 07:47:37.5 1",
    "PMRA 4.9 1", "PMDEC -3.9 1", "PX 0.85 1",
    "F0 218.8118437960826 1", "F1 -4.08e-16 1",
    "DM 15.99", "PEPOCH 54500", "POSEPOCH 54500", "DMEPOCH 54500",
    "TZRMJD 54500.1", "TZRSITE @", "TZRFRQ 1400", "UNITS TDB",
    "BINARY ELL1", "PB 67.8251 1", "A1 32.34242 1",
    "TASC 54500.2 1", "EPS1 3.9e-5 1", "EPS2 -7.4e-5 1",
    "DMEFAC -be X 1.1", "DMEQUAD -be X 1e-5",
]


def _isolated(n=NTOA):
    """The isolated fixture's reference model and TOAs."""
    rm = r_get_model(io.StringIO(ISOLATED_PAR))
    rng = np.random.default_rng(3)
    centers = np.sort(rng.uniform(53000, 56000, n // 4))
    mjds = (centers[:, None] + np.array([0.0, 0.007, 0.014, 0.021])).ravel()
    rt = r_fake(mjds, rm, error_us=1.0,
                freq_mhz=np.tile([1400.0, 2100.0], n // 2),
                add_noise=True, rng=rng)
    for i, f in enumerate(rt.flags):
        f["be"], f["grp"] = "X", f"g{i % 2}"
    dm = np.asarray(rm.total_dm(rt))
    for i, f in enumerate(rt.flags):
        f["pp_dm"] = repr(float(dm[i] + rng.normal(0.0, 1e-4)))
        f["pp_dme"] = "1e-4"
    return rm, rt


def _ell1(n=NTOA):
    """Config 3 at ``n`` TOAs: bench.config3_j1713like_wideband's recipe
    (its 10 DMX windows, default_rng(3) for the MJDs and then the -pp_dm
    draws, the TOAs simulated from seed 3)."""
    span0, span1 = 53000.0, 56000.0
    par = list(CONFIG3_PAR)
    bench._add_dmx(par, span0, span1, 10)
    rng = np.random.default_rng(3)
    mjds = np.sort(rng.uniform(span0, span1, n))
    freqs = np.tile([1400.0, 2100.0], n // 2)
    rm, rt = bench._make_model_toas(par, mjds, freqs, seed=3,
                                    flag_sets={"be": lambda i: "X"})
    for f in rt.flags:
        f["pp_dm"] = str(15.99 + rng.normal(0, 1e-4))
        f["pp_dme"] = "1e-4"
    return rm, rt


_BUILDERS = {"isolated": _isolated, "ell1": _ell1}
_BUILT: dict = {}


def wideband_problem(name):
    """(reference model, reference TOAs, port model, port TOAs), built
    once per module. The reference model is rebuilt from its own par
    output, as the port's is, so both start from the same digits."""
    if name not in _BUILT:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rm, rt = _BUILDERS[name]()
            par = rm.as_parfile()
            rm = r_get_model(io.StringIO(par))
            tm = get_model(io.StringIO(par), device=CPU)
        _BUILT[name] = (rm, rt, tm, toas_from_columns(rt, CPU))
    return _BUILT[name]


def reference_mode(name):
    """How the reference runs on a fixture: eagerly on the binary one
    (its compiled CPU phase of a binary is ~1e-6 turns off,
    test_torch_binary.py), compiled otherwise."""
    return jax.disable_jit() if name == "ell1" else contextlib.nullcontext()


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


# ------------------------------------------------------ flags, residuals


def test_flags_detection_and_missing_dme():
    """get_wideband_dm/has_wideband_dm and their errors, as
    tests/test_wideband.py:63-80 has them for the reference."""
    rm, rt, tm, tt = wideband_problem("isolated")
    assert has_wideband_dm(tt)
    dm, dme = get_wideband_dm(tt)
    rdm, rdme = r_get_wideband_dm(rt)
    assert _same(dm, rdm) and _same(dme, rdme)
    assert dm.shape == (NTOA,) and np.all(dme == 1e-4)
    r = DMResiduals(tt, tm)
    assert r.resids.dtype == torch.float64 and r.resids.shape == (NTOA,)
    assert float(torch.std(r.resids)) < 3 * 1e-4
    assert 0.3 < r.chi2 / NTOA < 3.0
    tcut = toas_from_columns(rt.select(np.arange(10)), CPU)
    for f in tcut.flags:
        f.pop("pp_dme")
    with pytest.raises(ValueError, match="pp_dme"):
        get_wideband_dm(tcut)
    tcut.flags[3].pop("pp_dm")
    assert not has_wideband_dm(tcut)
    with pytest.raises(ValueError, match="1/10 TOAs lack -pp_dm"):
        get_wideband_dm(tcut)


@pytest.mark.parametrize("name", ["isolated", "ell1"])
def test_dm_residuals_and_combined_chi2_match_reference(name):
    rm, rt, tm, tt = wideband_problem(name)
    rr, tr = RDMResiduals(rt, rm), DMResiduals(tt, tm)
    assert _same(rr.resids, tr.resids)
    assert _same(rr.dm_errors, tr.dm_errors)
    assert tr.chi2 == pytest.approx(rr.chi2, rel=1e-14)
    with reference_mode(name):
        rw = _quiet(RWBResiduals, rt, rm)
        rw_t = np.asarray(rw.toa.time_resids)
        rw_chi2 = rw.chi2
    tw = WidebandTOAResiduals(tt, tm)
    assert tw.dof == rw.dof == 2 * NTOA - len(tm.free_params) - 1
    sigma = rm.scaled_toa_uncertainty(rt)
    dr = _np(tw.toa.time_resids) - rw_t
    assert np.max(np.abs(dr)) <= 1e-12
    assert abs(tw.chi2 - rw_chi2) <= chi2_tol(rw_chi2, dr, sigma, 1e-12)
    assert tw.resids.shape == (2 * NTOA,)
    assert RexportDMResiduals is DMResiduals


# -------------------------------------------------------- model DM channel


def test_total_dm_and_scaled_uncertainty_match_reference():
    """DM, DM1 and DMX windows, a DMJUMP of each sign, and two DMEFAC and
    DMEQUAD mask groups: the model DM within 1e-14 relative, the scaled
    uncertainties bitwise."""
    rm0, rt, _, _ = wideband_problem("isolated")
    par = rm0.as_parfile() + "DM1 3e-4 1\nDMEPOCH 54800\n" \
        "DMJUMP -grp g0 -4e-4 1\nDMEFAC -grp g1 1.3\nDMEQUAD -grp g0 7e-5\n"
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    tt = toas_from_columns(rt, CPU)
    assert "DispersionJump" in tm.components and tm.DMJUMP2.value == -4e-4
    rdm, tdm = np.asarray(rm.total_dm(rt)), _np(tm.total_dm(tt))
    assert tdm.dtype == np.float64
    assert np.max(np.abs(tdm - rdm) / np.abs(rdm)) <= 1e-14
    assert _same(rm.scaled_dm_uncertainty(rt), tm.scaled_dm_uncertainty(tt))
    # the DMJUMP sign: a positive DMJUMP lowers the model DM of its subset
    g1 = np.array([f["grp"] == "g1" for f in tt.flags])
    tm.DMJUMP1.value = 2e-4
    tm.invalidate_cache(params_only=True)
    np.testing.assert_allclose(_np(tm.total_dm(tt))[g1], tdm[g1] - 2e-4,
                               rtol=0, atol=1e-12)
    assert tm.dm_affecting_free_params() == rm.dm_affecting_free_params()


def test_dm_noise_bases_bitwise_with_a_barycentred_row():
    """PLDMNoise's time basis, its weights and its DM-channel block, and
    the exclude= column alignment with ECORR, bitwise; a barycentred TOA
    (infinite frequency) has a zero DM row and no NaN."""
    rm, _, tm, _ = wideband_problem("isolated")
    mjds = np.linspace(53100.0, 55900.0, 41)
    mjds[1::2] = mjds[0::2][:20] + 0.01
    obs = ["gbt"] * 40 + ["@"]
    freqs = np.r_[np.tile([1400.0, 2100.0, 820.0, 430.0], 10), np.inf]
    flags = [{"be": "X", "grp": f"g{i % 2}", "pp_dm": "15.99",
              "pp_dme": "1e-4"} for i in range(41)]
    rt = _quiet(r_get_TOAs_array, np.sort(mjds), obs=obs, freqs=freqs,
                flags=flags)
    tt = toas_from_columns(rt, CPU)
    for excl in ((), ("EcorrNoise",)):
        F = tm.noise_model_designmatrix(tt, exclude=excl)
        assert _same(F, rm.noise_model_designmatrix(rt, exclude=excl))
        assert _same(tm.noise_model_basis_weight(tt, exclude=excl),
                     rm.noise_model_basis_weight(rt, exclude=excl))
        Fdm = tm.noise_model_dm_designmatrix(tt, exclude=excl)
        assert _same(Fdm, rm.noise_model_dm_designmatrix(rt, exclude=excl))
        assert Fdm.shape == F.shape and np.all(np.isfinite(Fdm))
        assert np.all(Fdm[-1] == 0.0) and np.any(Fdm[:-1] != 0.0)
    assert tm.noise_model_dimensions(tt) == rm.noise_model_dimensions(rt)


FD_PAR_EXTRA = ("FD2 -3e-7 1\nFDJUMP -grp g0 2e-6 1\n"
                "FD2JUMP -grp g1 -4e-7 1\n")


def test_fd_and_fdjump_delays_and_columns_match_reference():
    """FD1/FD2 and an order-1 and order-2 FD jump: the delays within
    1e-12 s (a barycentred row included, where they add nothing), the
    design columns (jacfwd, and the hybrid closed-form ones) within 1e-12
    of each column's largest entry on every row. At the barycentred
    row's infinite frequency the reference's jacfwd columns are NaN (the
    Doppler-shifted frequency's tangent is inf * 0 there; its closed-form
    columns are finite): where they are, the row is held to the
    reference with that TOA at 1e12 MHz, where the DM delay is far below
    1e-12 s. (The FD columns keep the reference's finite values: FD adds
    nothing at an infinite frequency but ln(1e9)^i at 1e12 MHz.) The
    components' own jacfwd tangents and closed-form columns at that row
    are finite zeros."""
    rm0, _, _, _ = wideband_problem("isolated")
    par = rm0.as_parfile() + FD_PAR_EXTRA
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    assert tm.components["FD"].fd_ids == [1, 2]
    assert tm.components["FDJump"].fdjumps == [(1, "FDJUMP1"),
                                               (2, "FD2JUMP1")]
    mjds = np.sort(np.linspace(53100.0, 55900.0, 31))
    freqs = np.r_[np.tile([1400.0, 2100.0, 820.0], 10), np.inf]
    obs = ["gbt"] * 30 + ["@"]
    flags = [{"grp": f"g{i % 2}"} for i in range(31)]
    rt = _quiet(r_get_TOAs_array, mjds, obs=obs, freqs=freqs, flags=flags)
    tt = toas_from_columns(rt, CPU)
    d_r, d_t = np.asarray(rm.delay(rt)), _np(tm.delay(tt))
    assert np.max(np.abs(d_t - d_r)) <= 1e-12
    Mr, nr, _ = rm.designmatrix(rt)
    Mr = np.asarray(Mr)
    rt12 = _quiet(r_get_TOAs_array, mjds, obs=obs,
                  freqs=np.r_[freqs[:-1], 1e12], flags=flags)
    M12 = np.asarray(rm.designmatrix(rt12)[0])
    assert not np.all(np.isfinite(Mr[-1])) and np.all(np.isfinite(M12))
    Mr[-1] = np.where(np.isfinite(Mr[-1]), Mr[-1], M12[-1])
    Mt, nt, _ = tm.designmatrix(tt)
    assert nt == nr and {"FD1", "FD2", "FDJUMP1", "FD2JUMP1"} <= set(nt)
    Mt = _np(Mt)
    assert np.all(np.isfinite(Mt))
    # DMJUMP's column is zero in the time rows
    assert not np.any(Mt[:, nt.index("DMJUMP1")])
    err = np.max(np.abs(Mt - Mr), axis=0) / np.maximum(
        np.max(np.abs(Mr), axis=0), 1e-300)
    assert np.max(err) <= 1e-12
    lin = {"FD1", "FD2", "FDJUMP1", "FD2JUMP1"}
    assert lin <= tm.linear_design_names() == rm.linear_design_names()
    cache = tm.get_cache(tt, CPU)
    th, tl, fh, fl = (torch.as_tensor(x, dtype=torch.float64)
                      for x in tm._pack()[2:])
    hyb = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache,
                             hybrid=True).numpy()
    ad = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache).numpy()
    err = np.abs(hyb - ad) / np.maximum(np.max(np.abs(ad), axis=0), 1e-300)
    assert np.max(err) < 1e-12
    # each component alone, on the batch frequencies (inf in the last row)
    free, frozen = tm._pack()[:2]
    batch = cache["batch"]
    for comp in (tm.components["FD"], tm.components["FDJump"]):
        names = comp.linear_design_names()
        idx = [free.index(nm) for nm in names]

        def delay(x, comp=comp, idx=idx):
            pv = make_pv(free, frozen, th.index_put(
                (torch.as_tensor(idx),), x), tl, fh, fl)
            return comp.delay(pv, batch, cache["main"], {}, None)

        jac = torch.func.jacfwd(delay)(th[idx]).numpy()
        assert np.all(np.isfinite(jac)) and np.all(jac[-1] == 0.0)
        pv = make_pv(free, frozen, th, tl, fh, fl)
        cols = comp.linear_design_local(pv, batch, cache["main"], {})
        for k, nm in enumerate(names):
            g = _np(cols[nm][1])
            assert g[-1] == 0.0
            np.testing.assert_allclose(g, jac[:, k], rtol=1e-15, atol=0)


def test_builder_routes_every_wideband_key():
    """Every par key of config 3 and of the wideband twin (DMJUMP,
    DMEFAC, DMEQUAD, TNDM*, FD*, FD<n>JUMP) builds its component, the
    same components and packed parameters as the reference, and
    as_parfile writes the lines back."""
    rm0, _, _, _ = wideband_problem("isolated")
    par = rm0.as_parfile() + FD_PAR_EXTRA + "FD3 1e-8\nFD1JUMP -fe A 1e-7\n"
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    assert sorted(tm.components) == sorted(rm.components)
    assert {"DispersionJump", "ScaleDmError", "PLDMNoise", "FD",
            "FDJump"} <= set(tm.components)
    assert tm._pack()[:2] == rm._pack()[:2]
    for a, b in zip(tm._pack()[2:], rm._pack()[2:]):
        assert _same(a, b)
    out = tm.as_parfile()
    for key in ("DMJUMP", "DMEFAC", "DMEQUAD", "TNDMAMP", "TNDMGAM",
                "TNDMC", "FD1 ", "FD2 ", "FD3 ", "FDJUMP", "FD2JUMP",
                "FD1JUMP"):
        assert re.search(rf"^{key}", out, re.M), key
    again = get_model(io.StringIO(out), device=CPU)
    assert again._pack()[:2] == tm._pack()[:2]
    for a, b in zip(again._pack()[2:], tm._pack()[2:]):
        assert _same(a, b)


# ------------------------------------------------------- design and fits


@pytest.mark.parametrize("name", ["isolated", "ell1"])
def test_dm_designmatrix_matches_reference_jacfwd(name):
    """build_dm_designmatrix against the reference's jax.jacfwd of the
    same DM function, within 1e-12 of each column's largest entry."""
    rm, rt, tm, tt = wideband_problem(name)
    _, names, _ = tm.designmatrix(tt)
    r = np.asarray(r_dm_design(rm, rt, names))
    t = build_dm_designmatrix(tm, tt, names)
    assert t.dtype == torch.float64 and t.shape == (NTOA, len(names))
    t = _np(t)
    assert np.all(t[:, 0] == 0.0) and names[0] == "Offset"
    scale = np.maximum(np.max(np.abs(r), axis=0), 1e-300)
    assert np.max(np.abs(t - r) / scale) <= 1e-12
    assert np.any(t != 0.0)


def test_solve_once_matches_reference():
    """One stacked solve at the same point: the reference's _solve_once
    and the port's."""
    rm, rt, tm, tt = wideband_problem("isolated")
    rx, rcov, rchi2, rnoise, rnames = RWBFitter(rt, rm)._solve_once()
    f = WidebandTOAFitter(tt, tm)
    x, cov, chi2, noise, names = f._solve_once()
    assert names == rnames and noise.shape == (NTOA,)
    sig = np.sqrt(np.diag(rcov))
    assert np.max(np.abs(x - rx) / sig) <= 1e-6
    assert np.max(np.abs(np.diag(cov) - np.diag(rcov)) / np.diag(rcov)) \
        <= 1e-8
    dr = _np(f.resids.time_resids) - np.asarray(
        RResiduals(rt, rm).time_resids)
    sigma = rm.scaled_toa_uncertainty(rt)
    assert abs(chi2 - rchi2) <= chi2_tol(rchi2, dr, sigma, 1e-9)
    np.testing.assert_allclose(_np(noise), np.asarray(rnoise), rtol=1e-6,
                               atol=1e-13)


def _fresh(name):
    """The fixture's par as new reference and port models (the fits move
    their parameters), and its TOAs."""
    rm, rt, tm, tt = wideband_problem(name)
    par = rm.as_parfile()
    return (_quiet(r_get_model, io.StringIO(par)), rt,
            _quiet(get_model, io.StringIO(par), device=CPU), tt)


def test_wideband_downhill_reaches_reference_optimum():
    """WidebandDownhillFitter from F0 moved by 5e-11 Hz (config 3's
    start) and DMX_0001 by 1e-3: the same optimum as the reference's
    within 1e-6 sigma."""
    rm, rt, tm, tt = _fresh("isolated")
    for m in (rm, tm):
        m.F0.add_delta(5e-11)
        m.DMX_0001.add_delta(1e-3)
        m.invalidate_cache(params_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rf, tf = RWBDownhill(rt, rm), WidebandDownhillFitter(tt, tm)
        rchi2, tchi2 = rf.fit_toas(), tf.fit_toas()
    assert tf.converged and tf.stats.iterations == rf.stats.iterations
    assert tf.stats.dof == rf.stats.dof == 2 * NTOA - len(tm.free_params) - 1
    dr = _np(tf.resids.time_resids) - np.asarray(rf.resids.time_resids)
    sigma = rm.scaled_toa_uncertainty(rt)
    assert abs(tchi2 - rchi2) <= chi2_tol(rchi2, dr, sigma, 1e-9)
    assert tf.chi2_dm == pytest.approx(rf.chi2_dm, rel=1e-9)
    for nm in rm.free_params:
        rp, tp = rm.get_param(nm), tm.get_param(nm)
        assert abs(tp.value - rp.value) <= 1e-6 * rp.uncertainty, nm
        assert tp.uncertainty == pytest.approx(rp.uncertainty, rel=1e-6)
    assert tf.noise_resids.shape == (NTOA,)


def test_wideband_toa_fitter_matches_reference():
    """WidebandTOAFitter.fit_toas (maxiter 2) on both sides."""
    rm, rt, tm, tt = _fresh("isolated")
    for m in (rm, tm):
        m.F0.add_delta(5e-11)
        m.invalidate_cache(params_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rchi2 = RWBFitter(rt, rm).fit_toas(maxiter=2)
        tf = WidebandTOAFitter(tt, tm)
        tchi2 = tf.fit_toas(maxiter=2)
    assert tchi2 == pytest.approx(rchi2, rel=1e-8)
    for nm in rm.free_params:
        rp, tp = rm.get_param(nm), tm.get_param(nm)
        assert abs(tp.value - rp.value) <= 1e-6 * rp.uncertainty, nm


def test_fitter_auto_picks_the_wideband_fitters():
    rm, rt, tm, tt = wideband_problem("isolated")
    assert type(Fitter.auto(tt, tm)) is WidebandDownhillFitter
    assert type(Fitter.auto(tt, tm, downhill=False)) is WidebandTOAFitter
    assert type(_quiet(RFitter.auto, rt, rm)) is RWBDownhill
    with pytest.raises(ValueError, match="serve= cannot fit wideband"):
        Fitter.auto(tt, tm, serve=object())
    with pytest.raises(ValueError, match="streaming=True cannot fit"):
        Fitter.auto(tt, tm, streaming=True)
    fd = Fitter.auto(tt, tm, device=True)
    assert type(fd).__name__ == "DeviceDownhillGLSFitter" and fd.wideband


def test_pintempo_fits_a_wideband_tim(tmp_path, capsys):
    """The pintempo CLI on the isolated fixture written as .par and .tim
    (the -pp_dm/-pp_dme flags ride the .tim): it picks the wideband
    downhill fitter, and its fit is the one WidebandDownhillFitter
    reaches on the same files."""
    from pint_tpu_torch.scripts.pintempo import main as t_main

    rm, rt, _, _ = wideband_problem("isolated")
    par, tim, out = (tmp_path / n for n in ("w.par", "w.tim", "post.par"))
    par.write_text(rm.as_parfile())
    rt.write_TOA_file(str(tim))
    assert _quiet(t_main, [str(par), str(tim), "--outfile", str(out),
                           "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "WidebandDownhillFitter" in text and "on cpu" in text
    post = get_model(str(out), device=CPU)
    tt = _quiet(get_TOAs, str(tim), device=CPU)
    assert has_wideband_dm(tt)
    tf = WidebandDownhillFitter(tt, get_model(str(par), device=CPU))
    _quiet(tf.fit_toas)
    for nm in tf.model.free_params:
        # the written par rounds a value to its last bit or two (RAJ's
        # sexagesimal text): that much more is allowed
        p, q = post.get_param(nm), tf.model.get_param(nm)
        assert abs(p.value - q.value) <= 1e-6 * q.uncertainty + \
            4 * np.spacing(abs(q.value)), nm
