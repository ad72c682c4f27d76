"""TOAs at an infinite frequency in the port (pint_tpu_torch) against the
reference pint_tpu on the CPU: a par file without TZRFRQ (or with TZRFRQ
0) puts the TZR TOA at nu = inf, and a barycentred TOA has nu = inf.

There the reference's jacfwd design columns are NaN: the tangent of the
Doppler-shifted frequency nu (1 - v.n) is inf * 0. The port keeps that
frequency, and its tangent, out of the product, and the DM delay's
1/nu^2 goes through a finite stand-in, so its columns are finite and 0
where a parameter does not move the TOA. The oracle is the reference at
a huge finite frequency, 1e12 MHz, where the DM delay (DMconst DM / nu^2,
~1e-19 s for NGC6440E's DM of 224) is far below 1e-12 s: design columns
within 1e-10 of each column's largest entry, and the fitted parameters
within 1e-6 sigma."""

import io
import re
import warnings

import numpy as np
import pytest

from pint_tpu.fitter import Fitter as RFitter
from pint_tpu.models import get_model as r_get_model
from pint_tpu.toa import get_TOAs as r_get_TOAs

from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns

CPU = "cpu"
NGC_PAR = "tests/datafile/NGC6440E.par"
NGC_TIM = "tests/datafile/NGC6440E.tim"
COL_REL = 1e-10   # design columns, of each column's largest entry
FIT_SIGMA = 1e-6  # fitted parameters, in their uncertainties


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _par(tzrfrq):
    """NGC6440E's par text with its TZRFRQ line replaced by ``tzrfrq``
    (None: no TZRFRQ line)."""
    with open(NGC_PAR) as f:
        text = re.sub(r"(?m)^TZRFRQ.*\n", "", f.read())
    return text if tzrfrq is None else text + f"TZRFRQ {tzrfrq}\n"


_TOAS: dict = {}


def _toas():
    """(reference TOAs, port TOAs holding the same host columns)."""
    if not _TOAS:
        rt = _quiet(r_get_TOAs, NGC_TIM)
        _TOAS["t"] = (rt, toas_from_columns(rt, CPU))
    return _TOAS["t"]


@pytest.mark.parametrize("tzrfrq", [None, 0], ids=["missing", "zero"])
def test_designmatrix_without_tzrfrq_is_finite(tzrfrq):
    rt, tt = _toas()
    tm = _quiet(get_model, io.StringIO(_par(tzrfrq)), device=CPU)
    Mt, nt, _ = tm.designmatrix(tt)
    Mt = Mt.numpy()
    assert np.all(np.isfinite(Mt))
    # the reference itself is NaN there (every row of its jacfwd columns)
    rm_inf = _quiet(r_get_model, io.StringIO(_par(tzrfrq)))
    assert not np.all(np.isfinite(np.asarray(rm_inf.designmatrix(rt)[0])))
    rm = _quiet(r_get_model, io.StringIO(_par("1e12")))
    Mr, nr, _ = rm.designmatrix(rt)
    Mr = np.asarray(Mr)
    assert nt == nr
    err = np.max(np.abs(Mt - Mr), axis=0) / np.max(np.abs(Mr), axis=0)
    assert np.max(err) <= COL_REL, dict(zip(nt, err))


@pytest.mark.parametrize("tzrfrq", [None, 0], ids=["missing", "zero"])
def test_fit_without_tzrfrq_converges(tzrfrq):
    """Fitter.auto's fit of the par without TZRFRQ (it raised in
    linalg.svd on the NaN design before) against the reference's fit at
    TZRFRQ 1e12."""
    rt, tt = _toas()
    tm = _quiet(get_model, io.StringIO(_par(tzrfrq)), device=CPU)
    f = Fitter.auto(tt, tm)
    chi2 = f.fit_toas()
    assert f.converged and np.isfinite(chi2)
    rm = _quiet(r_get_model, io.StringIO(_par("1e12")))
    rf = RFitter.auto(rt, rm)
    assert type(rf).__name__ == type(f).__name__
    rchi2 = _quiet(rf.fit_toas)
    assert chi2 == pytest.approx(rchi2, rel=1e-8)
    for n in tm.free_params:
        a, b = rm.get_param(n), tm.get_param(n)
        assert abs(a.value - b.value) <= FIT_SIGMA * a.uncertainty, n
        assert b.uncertainty == pytest.approx(a.uncertainty, rel=1e-6), n


def test_barycentred_toa_rows_are_finite():
    """NGC6440E's TOAs plus barycentred copies of three of them (nu =
    inf at '@'): the port's rows there are finite and equal the
    reference's with those TOAs at 1e12 MHz."""
    from pint_tpu.toa import get_TOAs_array as r_get_TOAs_array
    from pint_tpu.toa import merge_TOAs as r_merge

    rt, _ = _toas()
    mjds = np.asarray(rt.get_mjds(), np.float64)[:3] + 0.3
    extra = {f: _quiet(r_get_TOAs_array, mjds, obs="@", freqs=f,
                       errors=5.0) for f in (np.inf, 1e12)}
    r_inf, r_12 = (_quiet(r_merge, [rt, extra[f]]) for f in (np.inf, 1e12))
    tt = toas_from_columns(r_inf, CPU)
    par = _par("1400")
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    Mt, nt, _ = tm.designmatrix(tt)
    Mt = Mt.numpy()
    assert np.all(np.isfinite(Mt))
    rm = _quiet(r_get_model, io.StringIO(par))
    assert not np.all(np.isfinite(np.asarray(rm.designmatrix(r_inf)[0])))
    Mr, nr, _ = rm.designmatrix(r_12)
    Mr = np.asarray(Mr)
    assert nt == nr and Mt.shape == Mr.shape
    err = np.max(np.abs(Mt - Mr), axis=0) / np.max(np.abs(Mr), axis=0)
    assert np.max(err) <= COL_REL, dict(zip(nt, err))
    # the barycentred rows' DM delay is 0: their DM column is the TZR
    # TOA's term alone, the same in each
    dm = nt.index("DM")
    assert np.max(np.abs(Mt[-3:, dm] - Mt[-3:, dm].mean())) <= \
        COL_REL * np.max(np.abs(Mt[:, dm]))
    chi2 = Fitter.auto(tt, tm).fit_toas()
    assert np.isfinite(chi2) and np.isfinite(tm.F0.uncertainty)
