"""The host API of the port's core classes against the reference on the
CPU: the TOAs methods (select, index, renumber, compute_pulse_numbers,
the MJD span), the TimingModel and PhaseJump methods (introspection,
set/get values, component removal, jumps, compare), d_phase_d_toa and
d_phase_d_param, the Residuals extras (resids_us, rms, ecorr_average),
the Phase extras and simulation's make_fake_toas_fromtim and
calculate_random_models.

Oracles: tests/test_toa.py, test_toa_surface.py, test_model.py,
test_polycos.py (d_phase_d_toa), test_fitter.py and test_gls.py
(ecorr_average). Phases of a binary model are compared with the
reference run eagerly (``jax.disable_jit()``), as in
test_torch_binary.py; isolated models with the compiled reference, to
the tolerance stated at each assertion."""

import io
import os

import jax
import numpy as np
import pytest
import torch

import pint_tpu.toa as rtoa
import pint_tpu_torch.toa as ttoa
from pint_tpu.models import get_model as r_get_model
from pint_tpu.residuals import Residuals as RResiduals
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake_mjds
from pint_tpu.simulation import make_fake_toas_uniform as r_fake_uniform
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

from test_torch_toa_io import _quiet

CPU = "cpu"
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datafile")
NGC_PAR = os.path.join(DATA, "NGC6440E.par")
NGC_TIM = os.path.join(DATA, "NGC6440E.tim")

# tests/test_model.py's introspection par, with an ECL-free astrometry
INTRO = ("PSR JINTRO\nRAJ 1:00:00 1\nDECJ 2:00:00 1\nF0 100 1\n"
         "F1 -1e-15 1\nPEPOCH 55000\nDM 10 1\n"
         "DMX_0001 1e-3 1\nDMXR1_0001 54000\nDMXR2_0001 54100\n"
         "DMX_0003 2e-3 1\nDMXR1_0003 54200\nDMXR2_0003 54300\n"
         "JUMP -grp a 1e-6 1\nEFAC -be X 1.1\nUNITS TDB\n")

# an ELL1 binary (tests/test_matrix_funcparam.py's), for the Doppler of
# an orbit in d_phase_d_toa
BINARY = """PSR J0020+0020
RAJ 02:00:00.0 1
DECJ 10:00:00.0 1
F0 99.0 1
F1 -1e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 7.0 1
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
BINARY ELL1
PB 1.2 1
A1 2.0 1
TASC 55000.1 1
EPS1 1e-5
EPS2 2e-5
M2 0.25
SINI 0.92
"""

# ECORR on clustered epochs, EFAC/EQUAD, some TOAs in no ECORR epoch
NOISE = """PSR J0006+0006
RAJ 06:00:00.0 1
DECJ 20:00:00.0 1
F0 220.0 1
F1 -1.5e-15 1
PEPOCH 55000
DM 15.0
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
EFAC -be X 1.1
EQUAD -be X 0.3
ECORR -be X 0.8
"""


def _pair(par):
    """(reference model, port model on the CPU) of one par text."""
    return (_quiet(r_get_model, io.StringIO(par)),
            _quiet(get_model, io.StringIO(par), device=CPU))


@pytest.fixture(scope="module")
def ngc():
    """(ref model, ref TOAs, port model, port TOAs) of NGC6440E: gbt
    TOAs with the clock chain applied."""
    rm = _quiet(r_get_model, NGC_PAR)
    pm = _quiet(get_model, NGC_PAR, device=CPU)
    return (rm, _quiet(rtoa.get_TOAs, NGC_TIM, model=rm), pm,
            _quiet(ttoa.get_TOAs, NGC_TIM, model=pm, device=CPU))


def _noise_pair(seed=3):
    """NOISE's models and TOAs in both packages: 10 four-TOA epochs and
    4 TOAs alone, the last two without the -be X flag."""
    rm, pm = _pair(NOISE)
    mjds = np.concatenate([
        (np.linspace(54100, 55900, 10)[:, None]
         + np.linspace(0, 0.02, 4)[None, :]).ravel(),
        [54050.0, 54075.0, 55950.0, 55975.0]])
    kw = dict(error_us=1.0, freq_mhz=1400.0, add_noise=True)
    rt = _quiet(r_fake_mjds, mjds, rm, rng=np.random.default_rng(seed),
                **kw)
    pt = _quiet(make_fake_toas_fromMJDs, mjds, pm,
                rng=np.random.default_rng(seed), **kw)
    for t in (rt, pt):
        for f in t.flags[:-2]:
            f["be"] = "X"
        t._touch()
    return rm, rt, pm, pt


# ------------------------------------------------------------ TOAs


def test_toas_surface_matches_reference(ngc):
    """len, get_obss and the MJD span equal the reference's."""
    _, rt, _, pt = ngc
    assert len(pt) == len(rt) == pt.ntoas
    assert pt.get_obss() == rt.get_obss()
    assert pt.first_MJD() == rt.first_MJD()
    assert pt.last_MJD() == rt.last_MJD()


def _table_state(t):
    """{attribute: comparable value} of a table's whole state."""
    out = {}
    for k, v in vars(t).items():
        if isinstance(v, tuple):
            v = tuple(np.asarray(x) for x in v)
        elif isinstance(v, dict) and k == "obs_planet_pos":
            v = {a: np.asarray(b) for a, b in v.items()}
        out[k] = v
    return out


def _photon_table():
    t = _quiet(ttoa.get_TOAs_array, 55000.0 + np.linspace(0, 20, 9),
               obs="gbt", freqs=1400.0, errors=2.0, planets=True,
               device=CPU)
    t.weights = np.linspace(0.1, 0.9, 9)
    return t


@pytest.mark.parametrize("table", ["tim", "array_weighted"])
def test_select_everything_carries_every_attribute(ngc, table):
    """select() of every TOA gives back every attribute of the table:
    an attribute added to TOAs without a rule in select() fails here.
    The serial is new; the TDB scratch of compute_TDBs is dropped."""
    t = ngc[3] if table == "tim" else _photon_table()
    t.index  # noqa: B018  (materialize the index column)
    sub = t.select(np.ones(t.ntoas, bool))
    want, got = _table_state(t), _table_state(sub)
    assert got.pop("_serial") != want.pop("_serial")
    for k in ttoa.TOAs._SELECT_DROPPED:
        want.pop(k, None)
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif isinstance(v, tuple):
            for a, b in zip(g, v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(v, dict) and k == "obs_planet_pos":
            assert set(g) == set(v)
            for a in v:
                np.testing.assert_array_equal(g[a], v[a], err_msg=k)
        else:
            assert g == v, k
    assert sub.flags is not t.flags and sub.flags[0] is not t.flags[0]


def test_select_subset_is_the_reference_subset_and_a_new_batch(ngc):
    """A subset equals the reference's subset column for column, and a
    model that has cached the parent's batch evaluates the subset afresh:
    its phase is the parent's phase at the selected rows (bitwise)."""
    rm, rt, pm, pt = ngc
    mask = np.arange(pt.ntoas) % 3 != 1
    rs, ps = rt.select(mask), pt.select(mask)
    for col in ("mjd_day", "freq_mhz", "error_us", "tdb_day",
                "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos", "index"):
        np.testing.assert_array_equal(getattr(ps, col), getattr(rs, col))
    for col in ("mjd_frac", "tdb_frac"):
        for a, b in zip(getattr(ps, col), getattr(rs, col)):
            np.testing.assert_array_equal(a, b)
    assert ps.flags == rs.flags and ps.obs == rs.obs
    full = pm.phase(pt)
    sub = pm.phase(ps)
    assert sub.turns.hi.shape[0] == int(mask.sum())
    idx = torch.as_tensor(np.flatnonzero(mask))
    assert torch.equal(sub.turns.hi, full.turns.hi[idx])
    assert torch.equal(sub.turns.lo, full.turns.lo[idx])


@pytest.mark.parametrize("case", ["survives_select", "index_order",
                                  "rank_order"])
def test_index_and_renumber_match_reference(case):
    """tests/test_toa_surface.py's TestIndexRenumber cases, both
    packages on the same table."""
    mjds = 50000.0 + np.linspace(0, 10, 8)
    rt = rtoa.get_TOAs_array(mjds, obs="barycenter", errors=1.0)
    pt = ttoa.get_TOAs_array(mjds, obs="barycenter", errors=1.0,
                             device=CPU)
    sel, renumber = {"survives_select": ([0, 2, 5], None),
                     "index_order": ([1, 4, 6], True),
                     "rank_order": ([6, 1, 4], False)}[case]
    out = []
    for t in (rt, pt):
        sub = t.select(np.array(sel))
        key = sub.cache_key
        if renumber is not None:
            sub.renumber(index_order=renumber)
            assert sub.cache_key != key
        out.append(list(sub.index))
    assert out[0] == out[1]
    assert list(pt.index) == list(range(8))


def test_compute_pulse_numbers_matches_reference(ngc):
    """-pn flags equal the reference's; the pulse-numbered residuals
    then equal the nearest-pulse ones to 1e-15 s (NGC6440E's residuals
    are far below half a turn)."""
    rm, rt, pm, pt = ngc
    rt2, pt2 = rt.select(np.ones(rt.ntoas, bool)), \
        pt.select(np.ones(pt.ntoas, bool))
    rt2.compute_pulse_numbers(rm)
    key = pt2.cache_key
    pt2.compute_pulse_numbers(pm)
    assert pt2.cache_key != key
    assert [f["pn"] for f in pt2.flags] == [f["pn"] for f in rt2.flags]
    r_pn = Residuals(pt2, pm)
    assert r_pn.track_mode == "use_pulse_numbers"
    r_near = Residuals(pt, pm, track_mode="nearest")
    assert float((r_pn.time_resids - r_near.time_resids).abs().max()) \
        <= 1e-15


# ------------------------------------------------------ TimingModel


def test_introspection_matches_reference():
    """params, the typed and prefixed look-ups, the categories and the
    component conveniences (tests/test_model.py's
    test_introspection_helpers) equal the reference's."""
    rm, pm = _pair(INTRO)
    assert pm.params == rm.params
    for kind in ("maskParameter", "floatParameter", "prefixParameter",
                 "MJDParameter", "AngleParameter"):
        assert pm.get_params_of_type(kind) == rm.get_params_of_type(kind)
    for prefix in ("DMX_", "F", "JUMP", "EFAC"):
        assert pm.get_prefix_mapping(prefix) == \
            rm.get_prefix_mapping(prefix)
    assert pm.get_prefix_mapping("DMX_") == {1: "DMX_0001",
                                             3: "DMX_0003"}
    assert pm.components_by_category == rm.components_by_category
    for name, comp in pm.components.items():
        rc = rm.components[name]
        assert comp.param_names == rc.param_names
        for prefix in ("JUMP", "EFAC"):
            assert [p.name for p in comp.mask_params_of(prefix)] == \
                [p.name for p in rc.mask_params_of(prefix)]
    assert pm.get_param_values() == rm.get_param_values()
    assert "JUMP1" in pm and "NOPE" not in pm


def _fake_pair(par, n=30, seed=0):
    """(ref model, ref TOAs, port model, port TOAs): TOAs simulated by the
    reference, carried to the port column by column, so both packages
    evaluate the same TOAs."""
    rm, pm = _pair(par)
    rt = _quiet(r_fake_uniform, 54000, 56000, n, rm, error_us=1.0,
                add_noise=True, rng=np.random.default_rng(seed))
    return rm, rt, pm, toas_from_columns(rt, CPU)


@pytest.mark.parametrize("edit", ["set_param_values", "remove_component",
                                  "add_jump"])
def test_model_edits_reach_the_next_phase(edit):
    """Each edit drops what the model has cached: the next phase moves,
    and it is the reference's after the same edit (to 1e-9 turns: the
    compiled reference against the port's eager chain)."""
    rm, rt, pm, pt = _fake_pair(INTRO.replace("JUMP -grp a 1e-6 1\n", ""))
    for t in (rt, pt):
        for i, f in enumerate(t.flags):
            f["fe"] = "430" if i % 3 == 0 else "L"
        t._touch()
    before = pm.phase(pt, abs_phase=False)
    for m in (rm, pm):
        if edit == "set_param_values":
            m.set_param_values({"F0": 100.0 + 1e-7, "DM": 10.5})
        elif edit == "remove_component":
            m.remove_component("DispersionDMX")
        else:
            p = m.get_or_create_component("PhaseJump").add_jump(
                key="-fe", key_value=("430",), value=2e-4, frozen=False)
            assert p.name == "JUMP1"
    after = pm.phase(pt, abs_phase=False)
    moved = (after.turns.hi - before.turns.hi) + \
        (after.turns.lo - before.turns.lo)
    assert float(moved.abs().max()) > 1e-4
    ref = rm.phase(rt, abs_phase=False)
    d = (after.turns.hi.numpy() - np.asarray(ref.turns.hi)) + \
        (after.turns.lo.numpy() - np.asarray(ref.turns.lo))
    assert np.max(np.abs(d)) <= 1e-9
    assert pm.free_params == rm.free_params
    assert pm.get_param_values() == rm.get_param_values()


def test_jump_flags_to_params_matches_reference():
    """tim-file JUMP blocks become one free JUMP selecting exactly the
    blocked TOAs, idempotently (tests/test_model.py's
    test_jump_flags_to_params), as in the reference."""
    par = ("PSR J0J0+0J0\nRAJ 5:00:00 1\nDECJ 5:00:00 1\nF0 99.0 1\n"
           "PEPOCH 55500\nDM 5.0\nUNITS TDB\n")
    lines = ["FORMAT 1"]
    mjds = np.linspace(55000, 56000, 30)
    for i in range(30):
        if i in (10, 20):
            lines.append("JUMP")
        lines.append(f" fake{i} 1400.0 {mjds[i]:.12f} 1.0 @")
    tim = "\n".join(lines) + "\n"
    out = []
    for get_m, get_t, kw in ((r_get_model, rtoa.get_TOAs, {}),
                             (get_model, ttoa.get_TOAs,
                              {"device": CPU})):
        m = _quiet(get_m, io.StringIO(par), **kw)
        t = _quiet(get_t, io.StringIO(tim), model=m, **kw)
        new = m.jump_flags_to_params(t)
        assert m.jump_flags_to_params(t) == []
        comp = m.components["PhaseJump"]
        out.append(([(p.name, p.key, list(p.key_value), p.frozen)
                     for p in new],
                    [p.name for p in comp.get_jump_param_objects()],
                    [list(np.flatnonzero(p.select_mask(t))) for p in new],
                    m.free_params))
    assert out[0] == out[1]
    assert out[1][2] == [list(range(10, 20))]


def test_get_or_create_component_and_compare_match_reference():
    rm, pm = _pair(INTRO)
    rm2, pm2 = _pair(INTRO.replace("F0 100 1", "F0 100.5 1")
                     .replace("DM 10 1\n", ""))
    for m in (rm2, pm2):
        assert m.get_or_create_component("PhaseJump") is \
            m.components["PhaseJump"]
        comp = m.get_or_create_component("FD")
        assert "FD" in m.components and comp is m.components["FD"]
    assert pm.compare(pm2) == rm.compare(rm2)
    assert "F0" in pm.compare(pm2) and pm.compare(pm) == ""


@pytest.mark.parametrize("case", ["ngc6440e", "binary"])
def test_d_phase_d_toa_matches_reference(ngc, case):
    """The full-pipeline frequency equals the reference's: NGC6440E
    (gbt, the clock chain undone and re-applied) against the compiled
    reference to rtol 1e-12, the ELL1 binary against the eager reference
    to rtol 1e-12. The model's TOA cache serves the caller's TOAs again
    afterwards."""
    if case == "ngc6440e":
        rm, rt, pm, pt = ngc
        ctx = jax.disable_jit(False)
    else:
        rm, rt, pm, pt = _fake_pair(BINARY, n=12, seed=1)
        ctx = jax.disable_jit()
    pm.phase(pt)
    cached = pm._cache
    f = pm.d_phase_d_toa(pt)
    assert pm._cache is cached
    assert isinstance(f, np.ndarray) and f.dtype == np.float64
    with ctx:
        want = rm.d_phase_d_toa(rt)
    np.testing.assert_allclose(f, want, rtol=1e-12, atol=0)
    assert np.ptp(f) / pm.F0.value > 5e-5   # the Doppler is there


def test_d_phase_d_param_is_the_designmatrix_column(ngc):
    """One jacfwd column equals F0 times designmatrix's (the relation of
    ref designmatrix) to 1e-13 of its largest entry, and the
    reference's d_phase_d_param to 1e-9 relative; a parameter that is
    not free raises ValueError."""
    rm, rt, pm, pt = ngc
    M, names, _ = pm.designmatrix(pt, incoffset=False)
    for p in ("F0", pm.free_params[-1]):
        col = pm.d_phase_d_param(pt, p)
        assert col.dtype == torch.float64 and col.shape == (pt.ntoas,)
        scale = max(1.0, float(col.abs().max()))
        assert float((col / pm.F0.value - M[:, names.index(p)]).abs()
                     .max()) <= 1e-13 * scale
        ref = np.asarray(rm.d_phase_d_param(rt, p))
        np.testing.assert_allclose(col.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * scale)
    with pytest.raises(ValueError):
        pm.d_phase_d_param(pt, "DM999")


# ------------------------------------------------------- Residuals


def test_resids_us_and_rms_match_reference(ngc):
    """resids_us to 1e-6 us (1e-12 s: the compiled reference rounds some
    delays an ulp apart, ~6e-14 s) and rms to 1e-9 relative."""
    rm, rt, pm, pt = ngc
    r, rr = Residuals(pt, pm), RResiduals(rt, rm)
    np.testing.assert_allclose(r.resids_us.numpy(),
                               np.asarray(rr.resids_us), rtol=0,
                               atol=1e-6)
    assert r.rms() == pytest.approx(rr.rms(), rel=1e-9)


@pytest.mark.parametrize("use_noise_model", [True, False])
def test_ecorr_average_matches_reference(use_noise_model):
    """The epoch averages over NOISE's ECORR epochs (four TOAs alone
    outside them) and over gap-separated epochs equal the reference's:
    counts and index sets exactly, the residual averages to 1e-12 s (the
    compiled reference's delays), the rest to 1e-12 relative."""
    rm, rt, pm, pt = _noise_pair()
    got = Residuals(pt, pm).ecorr_average(use_noise_model=use_noise_model)
    want = RResiduals(rt, rm).ecorr_average(
        use_noise_model=use_noise_model)
    assert list(got["n"]) == list(want["n"])
    assert len(got["n"]) == 14
    for a, b in zip(got["indices"], want["indices"]):
        np.testing.assert_array_equal(a, b)
    for k in ("mjds", "time_resids", "errors", "freqs"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_allclose(
            got[k].numpy(), want[k], err_msg=k,
            **({"rtol": 0, "atol": 1e-12} if k == "time_resids"
               else {"rtol": 1e-12}))


# ----------------------------------------------------------- Phase


def test_phase_extras_match_reference():
    """frac_dd, +, - and unary - of Phase, and phase_from_f64, bitwise
    the reference's on the same dd turns."""
    from pint_tpu.ops.dd import DD as RDD
    from pint_tpu.phase import Phase as RPhase
    from pint_tpu.phase import phase_from_f64 as r_from
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.phase import Phase, phase_from_f64

    rng = np.random.default_rng(4)
    hi = rng.uniform(-1e10, 1e10, 64).round() + rng.uniform(-0.5, 0.5, 64)
    lo = rng.uniform(-1e-7, 1e-7, 64)
    x = rng.uniform(-3.0, 3.0, 64)
    rp = RPhase(RDD(jax.numpy.asarray(hi), jax.numpy.asarray(lo)))
    tp = Phase(DD(torch.as_tensor(hi), torch.as_tensor(lo)))

    def same(t_dd, r_dd):
        np.testing.assert_array_equal(t_dd.hi.numpy(), np.asarray(r_dd.hi))
        np.testing.assert_array_equal(t_dd.lo.numpy(), np.asarray(r_dd.lo))

    with jax.disable_jit():
        same(tp.frac_dd, rp.frac_dd)
        same((tp + phase_from_f64(x, CPU)).turns, (rp + r_from(x)).turns)
        same((tp - torch.as_tensor(x)).turns, (rp - x).turns)
        same((-tp).turns, (-rp).turns)
        same((tp + tp).turns, (rp + rp).turns)
    assert phase_from_f64(torch.as_tensor(x)).turns.hi.device.type == CPU


# ------------------------------------------------------ simulation


def test_make_fake_toas_fromtim_matches_reference(ngc, tmp_path):
    """The tim file's TOAs moved onto integer model phase, with a white
    draw from the same generator: the reference's MJDs to 1e-15 d."""
    rm, _, pm, _ = ngc
    from pint_tpu.simulation import make_fake_toas_fromtim as r_fromtim
    from pint_tpu_torch.simulation import make_fake_toas_fromtim

    rt = _quiet(r_fromtim, NGC_TIM, rm, add_noise=True,
                rng=np.random.default_rng(5))
    pt = _quiet(make_fake_toas_fromtim, NGC_TIM, pm, add_noise=True,
                rng=np.random.default_rng(5))
    assert pt.device == torch.device(CPU) and pt.ntoas == rt.ntoas
    d = (pt.mjd_day - rt.mjd_day) + (pt.mjd_frac[0] - rt.mjd_frac[0]) \
        + (pt.mjd_frac[1] - rt.mjd_frac[1])
    assert np.max(np.abs(d)) <= 1e-15
    r = Residuals(pt, pm, subtract_mean=False, track_mode="nearest")
    assert float(r.time_resids.abs().max()) < 1e-4   # the white draw


@pytest.mark.parametrize("pulse_numbers", [False, True])
def test_calculate_random_models_matches_reference(ngc, pulse_numbers):
    """(Nmodels, ntoa) float64 tensor on the fitter's device; with the
    same generator, the reference's residual curves to 1e-12 s (with
    -pn flags on the TOAs too)."""
    from pint_tpu.fitter import WLSFitter as RWLS
    from pint_tpu.simulation import calculate_random_models as r_crm
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.simulation import calculate_random_models

    rm, rt, pm, pt = ngc
    rm2 = _quiet(r_get_model, NGC_PAR)
    pm2 = _quiet(get_model, NGC_PAR, device=CPU)
    rt2, pt2 = rt.select(np.ones(rt.ntoas, bool)), \
        pt.select(np.ones(pt.ntoas, bool))
    if pulse_numbers:
        rt2.compute_pulse_numbers(rm2)
        pt2.compute_pulse_numbers(pm2)
    rf, pf = RWLS(rt2, rm2), WLSFitter(pt2, pm2)
    _quiet(rf.fit_toas, maxiter=1)
    _quiet(pf.fit_toas, maxiter=1)
    want = r_crm(rf, rt2, Nmodels=3, rng=np.random.default_rng(7))
    got = calculate_random_models(pf, pt2, Nmodels=3,
                                  rng=np.random.default_rng(7))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.shape == (3, pt.ntoas) and got.device == pf.device
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert float(got.std(dim=0).max()) > 1e-7   # the draws spread
