"""The port's numpy-only host modules against the reference on the CPU:
utils, modelutils (with TimingModel.as_ECL/as_ICRS), derived_quantities,
pint_matrix and binaryconvert (oracles: tests/test_cli_utils.py,
test_derived_extra.py, test_matrix_funcparam.py and test_binary_zoo.py).
Each is a copy of the reference's host code over the port's classes, so
the same inputs give bitwise the same host values; what runs on the
device (a converted model's delays and phase, a design matrix) is held
to the reference with the tolerance stated at each assertion. Binary
delays are compared with the reference run eagerly
(``jax.disable_jit()``), as in test_torch_binary.py."""

import jax
import numpy as np
import pytest
import torch

import pint_tpu.derived_quantities as rdq
import pint_tpu.utils as rutils
import pint_tpu_torch.derived_quantities as tdq
import pint_tpu_torch.utils as tutils
from pint_tpu.binaryconvert import convert_binary as r_convert
from pint_tpu.fitter import WLSFitter as RWLS
from pint_tpu.pint_matrix import CovarianceMatrix as RCov
from pint_tpu.pint_matrix import DesignMatrix as RDM
from pint_tpu_torch.binaryconvert import convert_binary
from pint_tpu_torch.fitter import WLSFitter
from pint_tpu_torch.pint_matrix import (
    CovarianceMatrix,
    DesignMatrix,
    combine_design_matrices_by_param,
    combine_design_matrices_by_quantity,
)

from test_torch_host_api import _fake_pair, _pair, _quiet

CPU = "cpu"

# tests/test_cli_utils.py's pulsar with proper motion and two DMX windows
PAR = """PSR J0012+0012
RAJ 03:30:00.0 1
DECJ 22:00:00.0 1
PMRA 11.0 1
PMDEC -7.0 1
F0 312.0 1
F1 -4e-15 1
PEPOCH 55500
POSEPOCH 55500
DM 21.0
DMEPOCH 55500
DMX_0001 0.0 1
DMXR1_0001 54000
DMXR2_0001 55000
DMX_0002 0.0 1
DMXR1_0002 55000.5
DMXR2_0002 56000
TZRMJD 55500.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""

# tests/test_binary_zoo.py's J1012+5307-like base
ZOO = """PSR J1012+5307
RAJ 10:12:33.43
DECJ 53:07:02.5
PMRA 2.6
PMDEC -25.5
PX 1.2
F0 310.0 1
F1 -5e-16
PEPOCH 55000
POSEPOCH 55000
DM 9.0
DMEPOCH 55000
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""
ELL1 = ("BINARY ELL1\nPB 0.2\nA1 0.9 1\nTASC 55000.05\nEPS1 1.1e-5 1\n"
        "EPS2 -0.4e-5 1\nM2 0.2 1\nSINI 0.9\n")
DD = ("BINARY DD\nPB 0.6\nA1 1.45 1\nT0 55000.2\nECC 0.02 1\nOM 47.0 1\n"
      "GAMMA 1e-4\nM2 0.3\nSINI 0.95\n")
# the same orbit at e = 1.2e-5, where ELL1 is a valid approximation, and
# without GAMMA, which ELL1 does not carry
DD_LOW_E = DD.replace("ECC 0.02 1", "ECC 1.2e-5 1").replace("GAMMA 1e-4\n",
                                                          "")
# ELL1 without the Shapiro delay, which BT does not carry
ELL1_KEPLER = ELL1.replace("M2 0.2 1\nSINI 0.9\n", "")


@pytest.fixture(scope="module")
def fitted():
    """(ref model, ref TOAs, ref fitter, port model, port TOAs, port
    fitter): PAR at 80 TOAs over two bands, WLS-fitted twice."""
    from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake
    from pint_tpu_torch.models.convert import toas_from_columns

    rm, pm = _pair(PAR)
    mjds = np.concatenate([np.linspace(54000, 56000, 40),
                           np.linspace(54001, 55999, 40)])
    freqs = np.repeat([1400.0, 820.0], 40)
    rt = _quiet(r_fake, mjds, rm, error_us=1.0, freq_mhz=freqs,
                add_noise=True, rng=np.random.default_rng(2))
    pt = toas_from_columns(rt, CPU)
    rf, pf = RWLS(rt, rm), WLSFitter(pt, pm)
    _quiet(rf.fit_toas, maxiter=2)
    _quiet(pf.fit_toas, maxiter=2)
    return rm, rt, rf, pm, pt, pf


# ------------------------------------------------------------- utils


@pytest.mark.parametrize("call", [
    ("FTest", (200.0, 100, 120.0, 99)), ("FTest", (100.0, 100, 100.0, 99)),
    ("weighted_mean", ([1.0, 3.0, 4.5], [1.0, 2.0, 0.5])),
    ("get_highest_density_range", (np.linspace(50000, 50100, 57), 7.0)),
    ("format_uncertainty", (1.2345678, 8.9e-5)),
    ("format_uncertainty", (61.485476554, 0.96)),
    ("format_uncertainty", (3.0, None)),
    ("split_prefixed_name", ("DMX_0012",)),
])
def test_utils_functions_are_the_reference(call):
    name, args = call
    got, want = getattr(tutils, name)(*args), getattr(rutils, name)(*args)
    assert repr(got) == repr(want)


def test_utils_taylor_horner_on_tensors():
    """The re-exported Taylor series take tensors and equal the
    reference's to 1e-15 relative."""
    dt = np.linspace(-3e8, 3e8, 17)
    coeffs = [0.3, 218.8, -4.1e-16, 1e-27]
    for name in ("taylor_horner", "taylor_horner_deriv"):
        got = getattr(tutils, name)(torch.as_tensor(dt), coeffs)
        want = np.asarray(getattr(rutils, name)(dt, coeffs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def test_dmx_helpers_and_information_criteria(fitted):
    """dmxparse, dmx_ranges, add_dmx_ranges, wavex_setup,
    dmwavex_setup, AIC and BIC on the fitted pulsar, as the reference's
    (the two packages' fits: values within 1e-6 of their sigma and
    uncertainties within 1e-8 relative, the fit path's limits)."""
    rm, rt, rf, pm, pt, pf = fitted
    got, want = tutils.dmxparse(pf), rutils.dmxparse(rf)
    assert got["bins"] == want["bins"] == ["0001", "0002"]
    assert np.all(np.abs(got["dmxs"] - want["dmxs"])
                  <= 1e-6 * want["dmx_verrs"])
    np.testing.assert_allclose(got["dmx_verrs"], want["dmx_verrs"],
                               rtol=1e-8)
    for k in ("dmxeps", "r1s", "r2s"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tutils.dmx_ranges(pt) == rutils.dmx_ranges(rt)
    # the fits' chi2 moves with the last bits of the residuals (the
    # compiled reference's delays): 1e-7 relative
    for fn in ("akaike_information_criterion",
               "bayesian_information_criterion"):
        assert getattr(tutils, fn)(pf) == pytest.approx(
            getattr(rutils, fn)(rf), rel=1e-7)
    rm2, pm2 = _pair(PAR)
    assert tutils.add_dmx_ranges(pm2, pt, max_window_days=100.0) == \
        rutils.add_dmx_ranges(rm2, rt, max_window_days=100.0)
    assert tutils.wavex_setup(pm2, 1000.0, 3) == \
        rutils.wavex_setup(rm2, 1000.0, 3)
    assert tutils.dmwavex_setup(pm2, 1000.0, 2) == \
        rutils.dmwavex_setup(rm2, 1000.0, 2)
    assert pm2.params == rm2.params
    assert pm2.get_param_values() == rm2.get_param_values()


def test_posvel_chains_like_the_reference():
    a = dict(pos=[1.0, 2.0, 3.0], vel=[0.1, 0.2, 0.3], origin="ssb",
             obj="earth")
    b = dict(pos=[0.5, -1.0, 2.0], vel=[0.0, 0.1, 0.0], origin="earth",
             obj="gbt")
    for op in (lambda x, y: x + y, lambda x, y: -x,
               lambda x, y: (x + y) - x):
        g = op(tutils.PosVel(**a), tutils.PosVel(**b))
        w = op(rutils.PosVel(**a), rutils.PosVel(**b))
        np.testing.assert_array_equal(g.pos, w.pos)
        np.testing.assert_array_equal(g.vel, w.vel)
        assert (g.origin, g.obj, repr(g)) == (w.origin, w.obj, repr(w))
    with pytest.raises(ValueError):
        tutils.PosVel(**b) + tutils.PosVel(**b)


# -------------------------------------------------- derived quantities


@pytest.mark.parametrize("name,args", [
    ("p_to_f", (0.0333, 4.2e-13)), ("f_to_p", (29.946923, -3.77535e-10)),
    ("mass_funct", (0.322997, 2.3418)),
    ("mass_funct2", (1.441, 1.387, 47.2)),
    ("companion_mass", (0.322997, 2.3418, 47.2, 1.441)),
    ("pulsar_mass", (0.322997, 2.3418, 1.387, 47.2)),
    ("pulsar_age", (29.946923, -3.77535e-10)),
    ("pulsar_edot", (29.946923, -3.77535e-10)),
    ("pulsar_B", (29.946923, -3.77535e-10)),
    ("pulsar_B_lightcyl", (29.946923, -3.77535e-10)),
    ("omdot", (1.4398, 1.3886, 0.322997448918, 0.6171334)),
    ("gamma", (1.4398, 1.3886, 0.322997448918, 0.6171334)),
    ("pbdot", (1.4398, 1.3886, 0.322997448918, 0.6171334)),
    ("shklovskii_factor", (10.0, 1.0)),
])
def test_derived_quantities_are_the_reference(name, args):
    assert repr(getattr(tdq, name)(*args)) == \
        repr(getattr(rdq, name)(*args))


@pytest.mark.parametrize("astrometry", [
    "RAJ 1:00:00\nDECJ 2:00:00\nPMRA 3.0\nPMDEC 4.0\n",
    "ELONG 10.0\nELAT 5.0\nPMELONG 6.0\nPMELAT 8.0\n",
    "RAJ 1:00:00\nDECJ 2:00:00\n"])
def test_pmtot_is_the_reference(astrometry):
    rm, pm = _pair("PSR TT\nF0 100 1\nDM 10\nPEPOCH 55000\nUNITS TDB\n"
                   + astrometry)
    assert tdq.pmtot(pm) == rdq.pmtot(rm)


# --------------------------------------------------------- modelutils


@pytest.mark.parametrize("ecl", ["IERS2010", "IERS2003", "IAU1976"])
def test_as_ecl_as_icrs_match_reference_and_keep_the_phase(ecl):
    """The converted parameters are bitwise the reference's (host
    numpy); the ecliptic model's phase on the port equals the
    equatorial one's to 2e-9 s (tests/test_cli_utils.py's bound) and
    the round trip returns RAJ to 1e-12 rad;
    same-frame calls return self; an unknown convention raises."""
    rm, rt, pm, pt = _fake_pair(PAR, n=30, seed=4)
    pe, re_ = pm.as_ECL(ecl), rm.as_ECL(ecl)
    assert pe.device == pm.device and "AstrometryEcliptic" in pe.components
    assert pe.params == re_.params
    for name in ("ELONG", "ELAT", "PMELONG", "PMELAT", "PX", "POSEPOCH"):
        assert (pe.get_param(name).value, pe.get_param(name).uncertainty,
                pe.get_param(name).frozen) == \
            (re_.get_param(name).value, re_.get_param(name).uncertainty,
             re_.get_param(name).frozen), name
    assert pe.as_ECL(ecl) is pe
    p0, p1 = pm.phase(pt), pe.phase(pt)
    d = (p1.turns.hi - p0.turns.hi) + (p1.turns.lo - p0.turns.lo)
    assert float(d.abs().max()) / pm.F0.value <= 2e-9
    back = pe.as_ICRS()
    assert back.as_ICRS() is back
    assert back.RAJ.value == pytest.approx(pm.RAJ.value, abs=1e-12)
    assert back.PMRA.value == re_.as_ICRS().PMRA.value
    other = "IERS2010" if ecl != "IERS2010" else "IERS2003"
    assert pe.as_ECL(other).ELONG.value == re_.as_ECL(other).ELONG.value
    with pytest.raises(ValueError, match="convention"):
        pm.as_ECL("NOTACONV")


# -------------------------------------------------------- pint_matrix


def test_design_and_covariance_matrices_match_reference(fitted):
    """DesignMatrix.from_model holds the port's designmatrix (computed
    on the model's device) on the host, with the reference's labels and
    units, its values to 1e-9 of each column's largest entry;
    CovarianceMatrix.from_fitter labels the port fitter's covariance,
    and its correlation table prints as the reference's."""
    rm, rt, rf, pm, pt, pf = fitted
    dm, rdm = DesignMatrix.from_model(pm, pt), RDM.from_model(rm, rt)
    assert isinstance(dm.matrix, np.ndarray)
    assert (dm.labels, dm.units, dm.quantity) == \
        (rdm.labels, rdm.units, rdm.quantity)
    assert dm.derivative_params() == rdm.derivative_params()
    M, names, _ = pm.designmatrix(pt)
    np.testing.assert_array_equal(dm.get_column("F0"),
                                  M[:, names.index("F0")].numpy())
    scale = np.max(np.abs(rdm.matrix), axis=0)
    assert np.all(np.abs(dm.matrix - rdm.matrix) <= 1e-9 * scale)
    cm, rcm = CovarianceMatrix.from_fitter(pf), RCov.from_fitter(rf)
    assert cm.labels == rcm.labels
    np.testing.assert_array_equal(cm.matrix, pf.parameter_covariance_matrix)
    np.testing.assert_allclose(cm.matrix, rcm.matrix, rtol=1e-8)
    np.testing.assert_allclose(np.diag(cm.to_correlation().matrix), 1.0,
                               atol=1e-12)
    assert RCov(cm.matrix, cm.labels).prettyprint() == cm.prettyprint()
    stacked = combine_design_matrices_by_quantity([dm, dm])
    assert stacked.shape == (2 * pt.ntoas, dm.shape[1])
    assert stacked.quantity == "toa+toa"
    other = DesignMatrix(np.ones((pt.ntoas, 1)), ["EXTRA"], ["s"])
    assert combine_design_matrices_by_param([dm, other]).labels[-1] == \
        "EXTRA"
    with pytest.raises(ValueError):
        combine_design_matrices_by_param([dm, dm])


# ------------------------------------------------------ binaryconvert


@pytest.mark.parametrize("src,target,delay_tol", [
    # exact reparameterizations: the delays of the converted model equal
    # the source's to 1e-12 s (tests/test_binary_zoo.py's ELL1H atol)
    ("ELL1", "ELL1H", 1e-12), ("DD", "DDS", 1e-12), ("DD", "DDH", 1e-12),
    # ELL1 is an O(e^2) expansion of the eccentric orbit:
    # test_binary_zoo.py's 2e-9 s at x e^2 ~ 1e-10 lt-s
    ("ELL1", "DD", 2e-9), ("ELL1_KEPLER", "BT", 2e-9),
    ("DD_LOW_E", "ELL1", 2e-9)])
def test_convert_binary_matches_reference(src, target, delay_tol):
    """The converted parameters are bitwise the reference's; the
    converted model's delay on the port equals the eager reference's to
    1e-12 s and, less their means (ELL1 leaves the constant -3/2 x eps1
    to the phase offset), the source model's to delay_tol; converting
    back gives the source parameterization again."""
    orbit = {"ELL1": ELL1, "DD": DD, "DD_LOW_E": DD_LOW_E,
             "ELL1_KEPLER": ELL1_KEPLER}[src]
    src = src.split("_")[0]
    rm, rt, pm, pt = _fake_pair(ZOO + orbit, n=24, seed=5)
    for m in (rm, pm):
        m.get_param("A1").uncertainty = 1e-7
        m.get_param("ECC" if src == "DD" else "EPS1").uncertainty = 1e-8
        m.get_param("OM" if src == "DD" else "EPS2").uncertainty = \
            1e-2 if src == "DD" else 1e-8
    got, want = convert_binary(pm, target), r_convert(rm, target)
    assert got.device == pm.device
    assert sorted(got.components) == sorted(want.components)
    assert got.params == want.params
    for n in got.params:
        a, b = got.get_param(n), want.get_param(n)
        assert (a.value, a.uncertainty, a.frozen) == \
            (b.value, b.uncertainty, b.frozen), n
    d_new = got.delay(pt).numpy()
    with jax.disable_jit():
        d_ref = np.asarray(want.delay(rt))
    np.testing.assert_allclose(d_new, d_ref, rtol=0, atol=1e-12)
    dd = d_new - pm.delay(pt).numpy()
    np.testing.assert_allclose(dd - dd.mean(), 0.0, rtol=0, atol=delay_tol)
    back = convert_binary(got, src)
    assert f"Binary{src}" in back.components
    assert back.params == r_convert(want, src).params
    assert pm.components[f"Binary{src}"] is not got.components.get(
        f"Binary{src}")


def test_convert_binary_refusals_match_reference():
    rm, pm = _pair(ZOO + ELL1)
    for conv, m in ((r_convert, rm), (convert_binary, pm)):
        with pytest.raises(ValueError, match="unknown binary"):
            conv(m, "NOPE")
        assert conv(m, "ELL1") is not m
    rm, pm = _pair(ZOO)
    with pytest.raises(ValueError, match="no binary"):
        convert_binary(pm, "DD")
