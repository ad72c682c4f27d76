"""The reference's kitchen-sink model (tests/test_all_components.py
SINK_PAR: every zoo family at once, an ELL1 binary, 35 free parameters)
in the port against the reference pint_tpu on the CPU:

- at the reference test's 50 TOAs: the design matrix against the
  reference's (eager, hybrid columns off) within 1e-10 of each column's
  largest entry, and each port column against a central finite
  difference of the port's own residuals at that test's steps and
  tolerances (rtol 5e-5, atol 5e-6 of the column's largest entry);
- at 300 TOAs in six bands (tests/test_all_components.py's zoo step
  fixture, where the frequency-shape columns are not collinear): a
  downhill GLS fit from the par values, the port's against the
  reference's, parameters within 1e-6 sigma and chi2 within 1e-9
  relative plus what the residual difference moves it by.

The reference runs eagerly: its compiled phase of a binary model is
~1e-6 turns from exact (ROADMAP.md §3), 8e-9 s of residual here."""

import io
import warnings

import jax
import numpy as np
import pytest

from pint_tpu.gls import DownhillGLSFitter as RDownhillGLS
from pint_tpu.models import get_model as r_get_model
from pint_tpu.simulation import make_fake_toas_uniform as r_fake_uniform
from pint_tpu.toa import merge_TOAs as r_merge

from pint_tpu_torch.gls import DownhillGLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.residuals import Residuals

from test_all_components import FD_STEPS, SINK_PAR
from test_torch_fit import _check_fit
from test_torch_photon import _quiet

CPU = "cpu"
COL_REL = 1e-10
FD_RTOL, FD_ATOL = 5e-5, 5e-6   # tests/test_all_components.py:155


@pytest.fixture(scope="module")
def sink():
    """(reference model, port model, reference TOAs, port TOAs): the
    reference test's fixture, 25 TOAs at 1400 and 25 at 430 MHz, all in
    JUMP/FDJUMP group a."""
    rm = _quiet(r_get_model, io.StringIO(SINK_PAR))
    tA = _quiet(r_fake_uniform, 54500, 55500, 25, rm, error_us=1.0,
                freq_mhz=1400.0)
    tB = _quiet(r_fake_uniform, 54510, 55490, 25, rm, error_us=1.0,
                freq_mhz=430.0)
    rt = _quiet(r_merge, [tA, tB])
    for f in rt.flags:
        f["grp"] = "a"
    rm.invalidate_cache()
    tm = _quiet(get_model, io.StringIO(SINK_PAR), device=CPU)
    return rm, tm, rt, toas_from_columns(rt, CPU)


def test_sink_builds_the_reference_model(sink):
    rm, tm, _, _ = sink
    assert sorted(tm.components) == sorted(rm.components)
    assert tm.free_params == rm.free_params and len(tm.free_params) == 35


def test_sink_designmatrix_matches_reference(sink, monkeypatch):
    rm, tm, rt, tt = sink
    monkeypatch.setenv("PINT_TPU_HYBRID_JAC", "off")
    with jax.disable_jit():
        Mr, nr, ur = rm.designmatrix(rt)
    Mt, nt, ut = tm.designmatrix(tt)
    assert nt == nr and ut == ur
    Mr = np.asarray(Mr)
    err = np.max(np.abs(Mt.numpy() - Mr), axis=0) / np.max(np.abs(Mr), axis=0)
    assert np.all(err <= COL_REL), str(dict(zip(nr, err.tolist())))


def test_sink_columns_match_finite_differences(sink):
    """Every free parameter's column against (r(p + h) - r(p - h)) / 2h
    of the port's residuals, at the reference test's steps."""
    _, tm, _, tt = sink
    M, names, _ = tm.designmatrix(tt, incoffset=False)
    M = M.numpy()
    failures = []
    for j, pname in enumerate(names):
        p = tm.get_param(pname)
        h = FD_STEPS.get(pname, max(abs(p.value or 0.0) * 1e-7, 1e-9))
        rs = []
        for d in (h, -2 * h, h):
            p.add_delta(d)
            tm.invalidate_cache(params_only=True)
            rs.append(_quiet(Residuals, tt, tm,
                             subtract_mean=False).time_resids.numpy())
        fd = (rs[0] - rs[1]) / (2 * h)
        scale = np.max(np.abs(fd)) + 1e-30
        if not np.allclose(M[:, j], fd, rtol=FD_RTOL, atol=FD_ATOL * scale):
            failures.append(
                f"{pname}: {np.max(np.abs(M[:, j] - fd)) / scale:.2e}")
    assert not failures, failures


def test_sink_downhill_fit_matches_reference():
    """The reference's zoo-step fixture: 300 TOAs over MJD 54100-55900 in
    six bands, simulated by the reference with white noise from
    default_rng(21), with JUMP/FDJUMP group a on three TOAs of four (the
    fixture's two of three make the group a function of the band, and
    offset, JUMP, FD1, FD2, FDJUMP, DM and CM seven functions of six
    frequencies: an exactly singular fit)."""
    rm = _quiet(r_get_model, io.StringIO(SINK_PAR))
    rt = _quiet(r_fake_uniform, 54100, 55900, 300, rm, error_us=1.0,
                freq_mhz=np.tile([1400.0, 820.0, 2100.0, 430.0, 327.0,
                                  3000.0], 50),
                add_noise=True, rng=np.random.default_rng(21))
    for i, f in enumerate(rt.flags):
        f["grp"] = "a" if i % 4 else "b"
    rm.invalidate_cache()
    tm = _quiet(get_model, io.StringIO(SINK_PAR), device=CPU)
    tt = toas_from_columns(rt, CPU)
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        rf, tf = RDownhillGLS(rt, rm), DownhillGLSFitter(tt, tm)
        rchi2, tchi2 = rf.fit_toas(), tf.fit_toas()
    assert tf.converged and tf.stats.iterations == rf.stats.iterations
    _check_fit(rf, tf, rchi2, tchi2)
