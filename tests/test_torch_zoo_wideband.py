"""The solar wind and the DM families of the zoo in the port's wideband
DM channel, at an infinite frequency, with SWM 1, and at a solar
conjunction, against the reference pint_tpu on the CPU.

- Wideband: test_torch_wideband.py's isolated fixture plus NE_SW (free),
  two SWX windows (not tiling the span: windows that cover every TOA
  hold NE_SW's column in their span, a singular fit) and DMWaveX at two
  frequencies: the model DM
  (``dm_total_device``, astrometry's pre-pass included) within 1e-12
  pc/cm^3, the DM-affecting parameters equal as sets (astrometry's join
  with NE_SW), and the stacked wideband step (the reference's parts run
  eagerly, its solve compiled, as in test_torch_wideband_step.py), with
  the hybrid split off and on: dparams within 1e-9 sigma, chi2 within
  1e-10 relative, cov within 1e-10 relative, residuals within 1e-12 s.
- nu = inf: a par without TZRFRQ and barycentred TOAs. The reference's
  DMWaveX, SolarWindDispersion and SWX divide by nu^2 directly, so their
  jacfwd rows there are NaN; the port's are finite and held to the
  reference at 1e12 MHz (as test_torch_nu_inf.py): columns within 1e-10
  of each column's largest entry, delays within 1e-12 s.
- SWM 1 with SWP free (the oracle of tests/test_btpiecewise_swm.py):
  the jacfwd columns, SWP's among them, within 1e-10 of each column's
  largest entry of the reference's.
- A pulsar 1 degree from the ecliptic, observed daily for a year: the
  delay within 1e-12 s and the columns within 1e-10, where the clipped
  arccos and sin of the elongation come closest to their limits."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import get_model as r_get_model
from pint_tpu.parallel import build_fit_parts as r_build_fit_parts
from pint_tpu.parallel.fit_step import _gls_core as r_gls_core
from pint_tpu.toa import get_TOAs_array as r_get_TOAs_array
from pint_tpu.toa import merge_TOAs as r_merge

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_fit_step

from test_torch_photon import _quiet
from test_torch_wideband import ISOLATED_PAR, wideband_problem
from test_torch_zoo import BASE, ZOO, zoo_toas

CPU = "cpu"
DM_ABS, DELAY_S, COL_REL = 1e-12, 1e-12, 1e-10
DP_SIGMA, COV_REL, CHI2_REL, RESID_S = 1e-9, 1e-10, 1e-10, 1e-12
REF_FLAGS = dict(wideband=True, anchored=False, jac_f32=False,
                 matmul_f32=False)

WB_EXTRA = """NE_SW 8.0 1
SWXDM_0001 1e-4 1
SWXR1_0001 53500
SWXR2_0001 54000
SWXDM_0002 2e-4 1
SWXR1_0002 55000
SWXR2_0002 55500
DMWXEPOCH 54500
DMWXFREQ_0001 0.001
DMWXSIN_0001 1e-4 1
DMWXCOS_0001 -1e-4 1
DMWXFREQ_0002 0.002
DMWXSIN_0002 5e-5 1
DMWXCOS_0002 2e-5 1
"""
SW_FAMILIES = ZOO["DMWaveX"] + ZOO["SolarWindDispersion"] + \
    ZOO["SolarWindDispersionX"]


def _col_err(a, b):
    return np.max(np.abs(a - b), axis=0) / np.maximum(
        np.max(np.abs(b), axis=0), 1e-300)


@pytest.fixture(scope="module")
def wideband():
    """(reference model, port model, reference TOAs, port TOAs)."""
    _, rt, _, tt = wideband_problem("isolated")
    par = ISOLATED_PAR + WB_EXTRA
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    return rm, tm, rt, tt


def test_model_dm_with_the_solar_wind(wideband):
    rm, tm, rt, tt = wideband
    rdm = np.asarray(rm.total_dm(rt))
    tdm = tm.total_dm(tt, device=CPU).numpy()
    assert np.max(np.abs(tdm - rdm)) <= DM_ABS
    # the solar wind and DMWaveX move the DM channel
    bare = _quiet(get_model, io.StringIO(ISOLATED_PAR), device=CPU)
    assert np.min(np.abs(tdm - bare.total_dm(tt).numpy())) > 0.0


def test_dm_affecting_params_add_astrometry(wideband):
    rm, tm, _, _ = wideband
    names = tm.dm_affecting_free_params()
    assert names == rm.dm_affecting_free_params()
    assert {"RAJ", "DECJ", "NE_SW", "SWXDM_0001", "DMWXSIN_0002"} <= names
    assert "F0" not in names
    # SWX alone reads no ctx: no astrometry then
    par = ISOLATED_PAR + WB_EXTRA.replace("NE_SW 8.0 1\n", "")
    alone = _quiet(get_model, io.StringIO(par), device=CPU)
    assert "RAJ" not in alone.dm_affecting_free_params()
    assert alone.dm_affecting_free_params() == _quiet(
        r_get_model, io.StringIO(par)).dm_affecting_free_params()


@pytest.mark.parametrize("hybrid", [False, True], ids=["jacfwd", "hybrid"])
def test_wideband_step_matches_reference(wideband, hybrid):
    rm, tm, rt, tt = wideband
    rparts, rargs, rnames, meta = r_build_fit_parts(
        rm, rt, hybrid_jac=hybrid, **REF_FLAGS)
    with jax.disable_jit():
        parts = rparts(*rargs)

    @jax.jit
    def solve(M, Fv, r0, nvec, valid, eid, tmask, phi, jvar):
        wt = tmask / nvec
        r = r0 - (jnp.sum(r0 * wt) / jnp.sum(wt)) * tmask
        dp, cov, chi2, _ = r_gls_core(M, Fv, phi, r, nvec, valid, eid,
                                      jvar, meta["nseg"], f32mm=False)
        return dp, cov, chi2, r[:rt.ntoas]

    rdp, rcov, rchi2, rr = (np.asarray(x) for x in
                            solve(*parts, rargs[7], rargs[11]))
    step, args, names = build_fit_step(tm, tt, device=CPU,
                                       hybrid_jac=hybrid, wideband=True)
    assert names == rnames
    dp, cov, chi2, r = (x.numpy() for x in step(*args))
    sig = np.sqrt(np.diag(rcov))
    assert np.max(np.abs(dp - rdp) / sig) <= DP_SIGMA
    assert abs(float(chi2) - float(rchi2)) <= CHI2_REL * abs(float(rchi2))
    assert np.max(np.abs(np.diag(cov) - np.diag(rcov)) / np.diag(rcov)) \
        <= COV_REL
    assert np.max(np.abs(r - rr)) <= RESID_S


def test_infinite_frequency_rows_are_finite():
    """A par without TZRFRQ (the TZR TOA at nu = inf) and three
    barycentred TOAs, with DMWaveX, NE_SW and SWX free."""
    par = BASE.replace("TZRFRQ 1400\n", "") + SW_FAMILIES
    rt0, _ = zoo_toas(60)
    mjds = np.asarray(rt0.get_mjds(), np.float64)[:3] + 0.3
    extra = {f: _quiet(r_get_TOAs_array, mjds, obs="@", freqs=f,
                       errors=1.0) for f in (np.inf, 1e12)}
    r_inf, r_12 = (_quiet(r_merge, [rt0, extra[f]]) for f in (np.inf, 1e12))
    tt = toas_from_columns(r_inf, CPU)
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    Mt, nt, _ = tm.designmatrix(tt)
    Mt = Mt.numpy()
    assert np.all(np.isfinite(Mt))
    rm_inf = _quiet(r_get_model, io.StringIO(par))
    Mr_inf = np.asarray(rm_inf.designmatrix(r_inf)[0])
    # the reference's own rows: NaN at nu = inf (ROADMAP.md §3)
    assert not np.all(np.isfinite(Mr_inf))
    rm = _quiet(r_get_model, io.StringIO(par + "TZRFRQ 1e12\n"))
    Mr, nr, _ = rm.designmatrix(r_12)
    Mr = np.asarray(Mr)
    assert nt == nr and Mt.shape == Mr.shape
    err = _col_err(Mt, Mr)
    assert np.max(err) <= COL_REL, dict(zip(nt, err))
    d_t = tm.delay(tt).numpy()
    d_r = np.asarray(rm.delay(r_12))
    assert np.max(np.abs(d_t - d_r)) <= DELAY_S
    # the hybrid closed-form columns are finite there too
    cache = tm.get_cache(tt, CPU)
    th, tl, fh, fl = (torch.as_tensor(x, dtype=torch.float64)
                      for x in tm._pack()[2:])
    hyb = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache,
                             hybrid=True).numpy()
    ad = tm.design_jacobian(th, tl, fh, fl, cache["batch"], cache).numpy()
    assert np.all(np.isfinite(hyb)) and np.max(_col_err(hyb, ad)) <= COL_REL


def _design_against_reference(par, rt, tt, monkeypatch):
    monkeypatch.setenv("PINT_TPU_HYBRID_JAC", "off")
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    with jax.disable_jit():
        rd = np.asarray(rm.delay(rt))
        Mr, nr, _ = rm.designmatrix(rt)
    Mt, nt, _ = tm.designmatrix(tt)
    assert nt == nr
    assert np.max(np.abs(tm.delay(tt).numpy() - rd)) <= DELAY_S
    err = _col_err(Mt.numpy(), np.asarray(Mr))
    assert np.max(err) <= COL_REL, dict(zip(nt, err))
    return tm, nt, Mt.numpy()


def test_swm1_with_free_swp_matches_reference(monkeypatch):
    par = BASE + "NE_SW 8.0 1\nSWM 1\nSWP 2.3 1\n"
    rt, tt = zoo_toas(100)
    _, names, M = _design_against_reference(par, rt, tt, monkeypatch)
    assert np.max(np.abs(M[:, names.index("SWP")])) > 0.0


def test_conjunction_matches_reference(monkeypatch):
    """ELONG 180, ELAT 1 (the Sun passes 1 degree from the pulsar each
    September), daily TOAs at gbt for a year, NE_SW and two SWX windows
    free (SWX's host direction through the ecliptic frame)."""
    par = BASE.replace("RAJ 10:12:33.43 1\nDECJ 53:07:02.5 1\n",
                       "ELONG 180.0 1\nELAT 1.0 1\n").replace(
        "PMRA 2.6 1\nPMDEC -25.5 1\n", "") \
        + ZOO["SolarWindDispersion"] \
        + "SWXDM_0001 1e-4 1\nSWXR1_0001 55000\nSWXR2_0001 55200\n" \
        + "SWXDM_0002 2e-4 1\nSWXR1_0002 55200\nSWXR2_0002 55365\n"
    mjds = np.arange(55000.0, 55365.0) + 0.4
    rt = _quiet(r_get_TOAs_array, mjds, obs="gbt",
                freqs=np.tile([1400.0, 820.0], 183)[:365], errors=1.0)
    tt = toas_from_columns(rt, CPU)
    tm, names, M = _design_against_reference(par, rt, tt, monkeypatch)
    assert "AstrometryEcliptic" in tm.components
    # the spike is there (over the TZR row's constant: at the
    # barycentre the Sun is ~0.005 AU away)
    ne = M[:, names.index("NE_SW")]
    ne = np.abs(ne - np.median(ne))
    assert ne.max() > 30.0 * np.median(ne)
