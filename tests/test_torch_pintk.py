"""pintk through both packages: each case of tests/test_pintk.py driven
headless through the reference's Pulsar/PlkState/editor classes and the
port's (``device="cpu"``), on the same par and tim files, and the
results held together.

The pulsar is test_pintk.py's ELL1 binary. The reference's compiled CPU
phase of a binary model is ~1e-6 turns off its eager phase (FMA
contraction of the dd transforms, ROADMAP.md §3), so every case runs the
reference under ``jax.disable_jit()``, as tests/test_torch_binary.py
does. Limits: fitted parameters within 1e-6 of their uncertainty, chi2
within 1e-10 relative plus what the residual difference explains
(test_torch_fit.chi2_tol), residuals within 1e-12 s, random-model
curves within 1e-12 s (test_torch_host_api.py's limit), plot arrays and
axes within 1e-12 relative; masks, jump names, the undo stack, pulse
numbers, colours and picks equal."""

import copy
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from pint_tpu.models import get_model as r_get_model
from pint_tpu.simulation import make_fake_toas_uniform as r_fake_uniform

from test_torch_fit import chi2_tol
from test_torch_toa_io import _quiet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SIGMA = 1e-6       # fitted values, in units of their uncertainty
RESID_S = 1e-12
CHI2_REL = 1e-10
REL = 1e-12        # plot arrays and axes

PAR = """
PSR J0613-0200
RAJ 06:13:43.97 1
DECJ -02:00:47.2 1
F0 326.6005670 1
F1 -1.023e-15 1
PEPOCH 55500
DM 38.78
BINARY ELL1
PB 1.198512 1
A1 1.09144 1
TASC 55000.1 1
EPS1 2e-6 1
EPS2 -3e-6 1
TZRMJD 55500.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""


@pytest.fixture(autouse=True)
def _eager_reference():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def psr_files(tmp_path_factory):
    """test_pintk.py's files: 50 TOAs simulated by the reference."""
    d = tmp_path_factory.mktemp("pintk_pair")
    model = _quiet(r_get_model, io.StringIO(PAR))
    toas = _quiet(r_fake_uniform, 55000, 56000, 50, model, error_us=1.0,
                  freq_mhz=1400.0, add_noise=True,
                  rng=np.random.default_rng(21))
    par, tim = d / "psr.par", d / "psr.tim"
    par.write_text(model.as_parfile())
    toas.write_TOA_file(tim)
    return str(par), str(tim)


def _pair(files):
    """(reference Pulsar, port Pulsar on the CPU) of the files."""
    from pint_tpu.pintk import Pulsar as RPulsar
    from pint_tpu_torch.pintk import Pulsar

    with jax.disable_jit():
        return (_quiet(RPulsar, *files),
                _quiet(Pulsar, *files, device=CPU))


@pytest.fixture()
def pair(psr_files):
    return _pair(psr_files)


@pytest.fixture(scope="module")
def fitted(psr_files):
    """Both pulsars after one fit (shared by the cases that only read
    the fitted state)."""
    r, p = _pair(psr_files)
    with jax.disable_jit():
        _quiet(r.fit)
        _quiet(p.fit)
    return r, p


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _close(a, b, rel=REL):
    a, b = np.asarray(a, float), _np(b).astype(float)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(a))), 1e-300) if a.size else 1.0
    np.testing.assert_allclose(b, a, rtol=rel, atol=rel * scale)


def assert_same_fit(r, p):
    """Fitted values within SIGMA of their uncertainty, uncertainties
    within 1e-8 relative, residuals within RESID_S, chi2 within
    CHI2_REL plus what the residual difference explains."""
    assert type(r.fitter).__name__ == type(p.fitter).__name__
    assert r.model.free_params == p.model.free_params
    for nm in r.model.free_params:
        pr, pp = r.model.get_param(nm), p.model.get_param(nm)
        assert abs(pr.value - pp.value) <= SIGMA * pr.uncertainty, nm
        assert pp.uncertainty == pytest.approx(pr.uncertainty, rel=1e-8)
    rr, pr_ = r.postfit_resids, p.postfit_resids
    dr = _np(pr_.time_resids) - np.asarray(rr.time_resids)
    assert np.max(np.abs(dr)) <= RESID_S
    sigma = r.all_toas.get_errors() * 1e-6
    chi2 = float(rr.chi2)
    assert abs(float(pr_.chi2) - chi2) <= chi2_tol(chi2, dr, sigma,
                                                   CHI2_REL)


def test_load_and_fit(fitted, psr_files):
    r, p = fitted
    assert p.all_toas.ntoas == r.all_toas.ntoas == 50
    assert p.fitted and r.fitted
    assert_same_fit(r, p)
    # undo restores the unfitted state in both (on copies: the fitted
    # pair is shared)
    r2, p2 = copy.copy(r), copy.copy(p)
    r2._undo_stack, p2._undo_stack = list(r._undo_stack), \
        list(p._undo_stack)
    assert r2.undo() and p2.undo()
    assert not r2.fitted and not p2.fitted
    assert p2.model.F0.value == r2.model.F0.value
    assert len(p2._undo_stack) == len(r2._undo_stack) == 0
    r0, p0 = _pair(psr_files)
    assert _np(p0.prefit_resids.rms_weighted()) == pytest.approx(
        r0.prefit_resids.rms_weighted(), rel=REL)


def test_selection_and_delete(pair):
    r, p = pair
    for x in (r, p):
        x.select_mjd_range(55000, 55200)
    assert np.array_equal(p.selected, r.selected) and r.selected.any()
    assert p.delete_TOAs() == r.delete_TOAs()
    assert p.all_toas.ntoas == r.all_toas.ntoas
    assert np.array_equal(p.all_toas.get_mjds(), r.all_toas.get_mjds())
    _close(r.prefit_resids.time_resids, p.prefit_resids.time_resids)
    assert p.undo() and r.undo()
    assert p.all_toas.ntoas == r.all_toas.ntoas == 50
    assert len(p._undo_stack) == len(r._undo_stack) == 0


def test_jump_unjump_roundtrip(pair):
    from pint_tpu.pintk.pulsar import GUI_JUMP_FLAG as R_FLAG
    from pint_tpu_torch.pintk.pulsar import GUI_JUMP_FLAG

    r, p = pair
    assert GUI_JUMP_FLAG == R_FLAG
    for x in (r, p):
        x.select_mjd_range(55400, 55600)
    assert p.jump_selection() == r.jump_selection()
    assert [f.get(GUI_JUMP_FLAG) for f in p.all_toas.flags] == \
        [f.get(R_FLAG) for f in r.all_toas.flags]
    assert p.model.free_params == r.model.free_params
    _quiet(r.fit)
    _quiet(p.fit)
    assert_same_fit(r, p)
    assert p.unjump_selection() == r.unjump_selection() == 1
    assert not any(GUI_JUMP_FLAG in f for f in p.all_toas.flags)
    assert len(p._undo_stack) == len(r._undo_stack) == 3


def test_jump_changes_model(pair):
    """A 50 us offset injected into a block, recovered by the free JUMP
    in both packages, to the same value."""
    from pint_tpu.ops import dd_np as r_dd
    from pint_tpu_torch.ops import dd_np

    r, p = pair
    block = np.asarray(r.all_toas.get_mjds()) >= 55500
    for x, dd in ((r, r_dd), (p, dd_np)):
        off = dd.div_f(dd.dd(np.where(block, 50e-6, 0.0)), 86400.0)
        x.all_toas.mjd_frac = dd.add(x.all_toas.mjd_frac, off)
        x.all_toas.tdb_frac = dd.add(x.all_toas.tdb_frac, off)
        x.all_toas._touch()
        x.select(block)
        x.jump_selection()
    _quiet(r.fit)
    _quiet(p.fit)
    assert_same_fit(r, p)
    jr = r.model.components["PhaseJump"]
    jp = p.model.components["PhaseJump"]
    assert jp.jumps == jr.jumps
    assert abs(jp.params[jp.jumps[-1]].value) == pytest.approx(50e-6,
                                                               rel=0.2)


def test_pulse_number_tracking(pair):
    r, p = pair
    for x in (r, p):
        x.compute_pulse_numbers()
    assert p.track_mode == r.track_mode == "use_pulse_numbers"
    assert np.array_equal(p.all_toas.get_pulse_numbers(),
                          r.all_toas.get_pulse_numbers())
    dr = _np(p.prefit_resids.time_resids) - \
        np.asarray(r.prefit_resids.time_resids)
    assert np.max(np.abs(dr)) <= RESID_S
    for x in (r, p):
        x.reset_pulse_numbers()
    assert p.all_toas.get_pulse_numbers() is None
    assert r.all_toas.get_pulse_numbers() is None


def test_random_models(fitted):
    import torch

    r, p = fitted
    want = np.asarray(r.random_models(n=5, rng=np.random.default_rng(3)))
    got = p.random_models(n=5, rng=np.random.default_rng(3))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.shape == (5, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_plot_data_and_orbital_phase(pair):
    r, p = pair
    want, got = r.plot_data(postfit=False), p.plot_data(postfit=False)
    assert set(got) == set(want)
    assert "orbital_phase" in got and "elongation" in got
    for k in ("mjds", "resids_us", "errors_us", "freqs", "orbital_phase",
              "elongation"):
        _close(want[k], got[k])
        assert isinstance(got[k], np.ndarray)
    assert got["obs"] == want["obs"]
    assert np.array_equal(got["selected"], want["selected"])
    assert got["rms_us"] == pytest.approx(want["rms_us"], rel=REL)
    assert got["chi2"] == pytest.approx(want["chi2"], rel=REL)


def _states(r, p):
    from pint_tpu.pintk.plk import PlkState as RState
    from pint_tpu_torch.pintk.plk import PlkState

    return RState(r), PlkState(p)


def test_plk_state_axes_and_selection(pair):
    r, p = pair
    rs, ps = _states(r, p)
    for ax in ("mjd", "orbital_phase", "serial"):
        rs.xaxis = ps.xaxis = ax
        for a, b in zip(rs.xy()[:3], ps.xy()[:3]):
            _close(a, b)
    rs.xaxis = ps.xaxis = "mjd"
    assert ps.select_rectangle(55000, 55100) == \
        rs.select_rectangle(55000, 55100)
    assert ps.select_rectangle(55900, 56000, extend=True) == \
        rs.select_rectangle(55900, 56000, extend=True)
    assert np.array_equal(p.selected, r.selected)
    rs.yaxis = ps.yaxis = "residual_phase"
    for a, b in zip(rs.xy()[:3], ps.xy()[:3]):
        _close(a, b)
    assert ps.title() == rs.title()


def test_color_modes(pair):
    from pint_tpu.pintk.colormodes import COLOR_MODES as R_MODES
    from pint_tpu.pintk.colormodes import point_colors as r_colors
    from pint_tpu_torch.pintk.colormodes import COLOR_MODES, point_colors

    r, p = pair
    p.select_mjd_range(55300, 55500)
    r.select_mjd_range(55300, 55500)
    rs, ps = _states(r, p)
    want, got = rs.xy()[3], ps.xy()[3]
    assert list(COLOR_MODES) == list(R_MODES)
    for mode in COLOR_MODES:
        assert point_colors(mode, got) == r_colors(mode, want), mode
        assert ps.colors(got) == rs.colors(want)
    with pytest.raises(ValueError):
        point_colors("nope", got)


def test_par_edit_apply(pair):
    from pint_tpu.pintk.paredit import ParEditState as RParEdit
    from pint_tpu_torch.pintk.paredit import ParEditState

    r, p = pair
    rst, pst = RParEdit(r), ParEditState(p)
    text = rst.current_text()
    assert pst.current_text() == text
    new = text.replace("326.6005670", "326.6005680")
    rst.apply(new)
    pst.apply(new)
    assert p.model.F0.value == r.model.F0.value == pytest.approx(
        326.6005680)
    assert str(p.model.device) == CPU
    assert not p.fitted and not r.fitted
    _close(r.prefit_resids.time_resids, p.prefit_resids.time_resids)
    with pytest.raises(Exception):
        rst.apply("PSR\nF0 not_a_number\n")
    with pytest.raises(Exception):
        pst.apply("PSR\nF0 not_a_number\n")


def test_tim_edit_roundtrip(pair):
    from pint_tpu.pintk.timedit import TimEditState as RTimEdit
    from pint_tpu_torch.pintk.timedit import TimEditState

    r, p = pair
    rst, pst = RTimEdit(r), TimEditState(p)
    text = rst.current_text()
    assert pst.current_text() == text
    cut = "\n".join(text.strip().splitlines()[:-1]) + "\n"
    _quiet(rst.apply, cut)
    _quiet(pst.apply, cut)
    assert p.all_toas.ntoas == r.all_toas.ntoas == 49
    assert str(p.all_toas.device) == CPU
    _close(r.prefit_resids.time_resids, p.prefit_resids.time_resids)
    assert p.undo() and r.undo()
    assert p.all_toas.ntoas == r.all_toas.ntoas == 50


def test_widgets_importable_headless():
    """The widget classes import (not instantiate) without a display,
    and importing the port's pintk imports neither Tk nor matplotlib."""
    code = ("import sys\n"
            "from pint_tpu_torch.pintk import Pulsar, main, plk, paredit, "
            "timedit, fitbox, colormodes\n"
            "assert all(hasattr(m, w) for m, w in ((plk, 'PlkWidget'), "
            "(paredit, 'ParWidget'), (timedit, 'TimWidget'), "
            "(fitbox, 'FitboxWidget')))\n"
            "bad = [m for m in ('tkinter', 'matplotlib') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_plk_state_zoom_history_and_visible_mask(pair):
    r, p = pair
    rs, ps = _states(r, p)
    x, y = rs.xy()[:2]
    xm = float(np.median(x))
    # the box's low y edge is padded off the data: the reference's
    # np.min(y) is a point's own value, which the port's y (within
    # 1e-12 relative, not bitwise) may fall either side of
    ylo = float(np.min(y) - 0.01 * np.ptp(y))
    steps = [("zoom", (x.min(), xm)),
             ("zoom", (x.min(), xm, ylo, float(np.median(y)))),
             ("out", ()), ("out", ()), ("zoom", (x.min(), xm)),
             ("reset", ())]
    for op, args in steps:
        for st in (rs, ps):
            {"zoom": st.zoom_rectangle, "out": st.zoom_out,
             "reset": st.reset_view}[op](*args)
        assert ps.xlim == rs.xlim and ps.ylim == rs.ylim
        assert ps._view_stack == rs._view_stack
        assert np.array_equal(ps.visible_mask(), rs.visible_mask())


def test_plk_state_random_models_overlay(fitted):
    r, p = fitted
    rs, ps = _states(r, p)
    rs.compute_random_models(n=4, rng=np.random.default_rng(5))
    ps.compute_random_models(n=4, rng=np.random.default_rng(5))
    x = ps.xy()[0]
    want, got = rs.overlay_arrays(rs.xy()[0]), ps.overlay_arrays(x)
    assert len(got) == len(want) == 4
    for (wx, wy), (gx, gy) in zip(want, got):
        _close(wx, gx)
        np.testing.assert_allclose(gy, wy, rtol=0, atol=1e-12 * 1e6)
    ps.random_curves = [np.zeros(len(x) + 1)]
    assert ps.overlay_arrays(x) == [] and ps.random_curves is None


def test_plk_extra_axes(pair):
    from pint_tpu.pintk.plk import XAXIS_CHOICES as R_AXES
    from pint_tpu_torch.pintk.plk import XAXIS_CHOICES

    r, p = pair
    assert XAXIS_CHOICES == R_AXES
    rs, ps = _states(r, p)
    for ax in XAXIS_CHOICES:
        rs.set_axis(xaxis=ax)
        ps.set_axis(xaxis=ax)
        for a, b in zip(rs.xy()[:3], ps.xy()[:3]):
            _close(a, b)


def test_fitbox_and_toa_info(pair):
    r, p = pair
    assert p.fittable_params() == r.fittable_params()
    for x in (r, p):
        x.set_fit_params(["F0", "F1"])
        with pytest.raises(KeyError):
            x.set_fit_params(["F0", "NOPE"])
    assert p.model.free_params == r.model.free_params
    _quiet(r.fit)
    _quiet(p.fit)
    assert_same_fit(r, p)
    want, got = r.toa_info(3), p.toa_info(3)
    assert set(got) == set(want)
    for k in want:
        if k == "resid_us":
            assert abs(got[k] - want[k]) <= RESID_S * 1e6
        else:
            assert got[k] == want[k], k


def test_plk_nearest_point_pick(pair):
    r, p = pair
    rs, ps = _states(r, p)
    x, y = rs.xy()[:2]
    ps.xy()
    for k in (0, 7, 31, 49):
        assert ps.nearest_point(float(x[k]), float(y[k])) == \
            rs.nearest_point(float(x[k]), float(y[k])) == k
        assert ps.nearest_point(float(x[k])) == \
            rs.nearest_point(float(x[k]))
    far = float(x.max() + 10 * np.ptp(x))
    assert ps.nearest_point(far) is None and rs.nearest_point(far) is None


def test_plk_nearest_point_zoom_aware(pair):
    r, p = pair
    rs, ps = _states(r, p)
    for st in (rs, ps):
        st.set_axis(xaxis="serial")
    y = rs.xy()[1]
    ps.xy()
    for st in (rs, ps):
        st.zoom_rectangle(-0.5, 2.5)
    for q in ((2.0, float(y[2])), (2.5, float(y[30])), (0.1, None)):
        assert ps.nearest_point(*q) == rs.nearest_point(*q)
