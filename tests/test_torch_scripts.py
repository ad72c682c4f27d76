"""The seven scripts of the port (pint_tpu_torch/scripts: compare_parfiles,
convert_parfile, pintbary, pintpublish, t2binary2pint, tcb2tdb, zima)
through both packages, the port with ``--device cpu``, on the fixtures
of tests/test_cli_extra.py and tests/test_cli_utils.py (the ELL1 and
DDK T2 par files, the TCB par file, NGC6440E).

Limits: the converters give the same component set and every parameter
value bitwise equal; compare_parfiles the same text; pintbary every
barycentric MJD within one unit of its last printed digit (1e-13 d) and
the port's delay within 1e-12 s of the reference's; zima (white and
correlated draws from one seed) the same flags, errors and frequencies
and TOAs within 1e-11 s; pintpublish on NGC6440E the same LaTeX table,
except that a value whose last printed digit straddles a rounding
boundary is compared as the fitted number, within 1e-3 of its
uncertainty."""

import io
import os

import numpy as np
import pytest

from test_cli_extra import BINPAR, T2PAR
from test_cli_utils import PAR as CLI_PAR
from test_torch_toa_io import _quiet

CPU = "cpu"
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datafile")
NGC_PAR = os.path.join(DATA, "NGC6440E.par")
NGC_TIM = os.path.join(DATA, "NGC6440E.tim")
BARY_DAY = 1e-13     # pintbary prints 13 decimals of the day
DELAY_S = 1e-12
ZIMA_S = 1e-11
PUB_SIGMA = 1e-3
# test_cli_utils.py's pulsar with a red-noise process, for zima's
# correlated draw
NOISY_PAR = CLI_PAR.replace("UNITS TDB", "TNREDAMP -13.0\nTNREDGAM 3.5\n"
                            "TNREDC 8\nUNITS TDB")


def _run(main, argv, capsys):
    """(return code, stdout) of one script's main."""
    capsys.readouterr()
    rc = _quiet(main, argv)
    return rc, capsys.readouterr().out


def _models(ref_path, port_path):
    from pint_tpu.models import get_model as r_get_model
    from pint_tpu_torch.models import get_model

    return (_quiet(r_get_model, str(ref_path)),
            _quiet(get_model, str(port_path), device=CPU))


def assert_same_model(rm, pm):
    """The same components and every parameter value bitwise equal."""
    assert list(pm.components) == list(rm.components)
    assert pm.params == rm.params
    for nm in rm.params:
        rv, pv = rm.get_param(nm).value, pm.get_param(nm).value
        assert type(pv) is type(rv) and (pv == rv or (pv != pv and
                                                       rv != rv)), nm


def _both(tmp_path, capsys, name, argv_of, device_arg=True):
    """Run script ``name`` of both packages; argv_of(tag) gives each
    one's arguments (tag "ref"/"port" to keep output files apart).
    Returns ((rc, out) of the reference, (rc, out) of the port)."""
    import importlib

    ref = importlib.import_module(f"pint_tpu.scripts.{name}")
    port = importlib.import_module(f"pint_tpu_torch.scripts.{name}")
    r = _run(ref.main, argv_of("ref"), capsys)
    p = _run(port.main, argv_of("port") + (["--device", CPU]
                                           if device_arg else []), capsys)
    return r, p


def test_convert_parfile_binary(tmp_path, capsys):
    par = tmp_path / "ell1.par"
    par.write_text(BINPAR.strip() + "\n")
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "convert_parfile",
        lambda t: [str(par), "-o", str(tmp_path / f"{t}.par"),
                   "--binary", "DD"])
    assert rc_r == rc_p == 0
    assert out_p.replace("port.par", "ref.par") == out_r
    rm, pm = _models(tmp_path / "ref.par", tmp_path / "port.par")
    assert "BinaryDD" in pm.components
    assert_same_model(rm, pm)
    assert (tmp_path / "port.par").read_text() == \
        (tmp_path / "ref.par").read_text()


def test_convert_parfile_stdout_passthrough(tmp_path, capsys):
    par = tmp_path / "ell1.par"
    par.write_text(BINPAR.strip() + "\n")
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "convert_parfile", lambda t: [str(par)])
    assert rc_r == rc_p == 0 and out_p == out_r
    assert "BINARY" in out_p and "ELL1" in out_p


def test_t2binary2pint_ddk(tmp_path, capsys):
    from pint_tpu.scripts.t2binary2pint import \
        t2_to_native_parfile as r_convert
    from pint_tpu_torch.scripts.t2binary2pint import t2_to_native_parfile

    converted = t2_to_native_parfile(T2PAR)
    assert converted == r_convert(T2PAR)
    assert "BINARY DDK" in converted
    assert t2_to_native_parfile(BINPAR) == r_convert(BINPAR) == BINPAR
    par = tmp_path / "t2.par"
    par.write_text(T2PAR.strip() + "\n")
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "t2binary2pint",
        lambda t: [str(par), str(tmp_path / f"{t}.par")])
    assert rc_r == rc_p == 0
    assert out_p.replace("port.par", "ref.par") == out_r
    rm, pm = _models(tmp_path / "ref.par", tmp_path / "port.par")
    assert "BinaryDDK" in pm.components
    assert_same_model(rm, pm)
    assert pm.get_param("KIN").value == pytest.approx(108.3)


def test_tcb2tdb(tmp_path, capsys):
    src = tmp_path / "in.par"
    src.write_text(CLI_PAR.replace("UNITS TDB", "UNITS TCB"))
    (rc_r, _), (rc_p, _) = _both(
        tmp_path, capsys, "tcb2tdb",
        lambda t: [str(src), str(tmp_path / f"{t}.par")])
    assert rc_r == rc_p == 0
    rm, pm = _models(tmp_path / "ref.par", tmp_path / "port.par")
    assert pm.UNITS.value == "TDB"
    assert_same_model(rm, pm)


def test_compare_parfiles(tmp_path, capsys):
    p1, p2 = tmp_path / "a.par", tmp_path / "b.par"
    p1.write_text(CLI_PAR)
    p2.write_text(CLI_PAR.replace("F0 312.0", "F0 312.00001"))
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "compare_parfiles", lambda t: [str(p1), str(p2)])
    assert rc_r == rc_p == 0
    assert out_p == out_r and "F0" in out_p


def _bary(out):
    return np.array([[float(v) for v in ln.split("->")]
                     for ln in out.strip().splitlines() if "->" in ln])


@pytest.mark.parametrize("source", ["radec", "binary_par"])
def test_pintbary(tmp_path, capsys, source):
    """Barycentric MJDs of both packages within one unit of the last
    printed digit, at a sky position and through a binary par file (its
    orbit stripped first), at gbt and 1400 MHz."""
    mjds = ["55000.0", "55123.4567", "55800.25", "56000.0"]
    if source == "radec":
        extra = ["--ra", "03:30:00.0", "--dec", "22:00:00.0"]
    else:
        par = tmp_path / "ell1.par"
        par.write_text(BINPAR.strip() + "\n")
        extra = ["--parfile", str(par), "--freq", "1400"]
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "pintbary",
        lambda t: mjds + ["--obs", "gbt"] + extra)
    assert rc_r == rc_p == 0
    want, got = _bary(out_r), _bary(out_p)
    assert got.shape == want.shape == (len(mjds), 2)
    assert np.array_equal(got[:, 0], want[:, 0])
    assert np.max(np.abs(got[:, 1] - want[:, 1])) <= BARY_DAY * (1 + 1e-6)


def test_pintbary_delay_matches_reference():
    """The delay pintbary subtracts: the port's (one model.delay of a
    get_TOAs_array batch) within 1e-12 s of the reference's."""
    from pint_tpu.models import get_model as r_get_model
    from pint_tpu.toa import get_TOAs_array as r_array
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs_array

    mjds = np.linspace(55000.0, 56000.0, 37)
    text = BINPAR.replace("BINARY ELL1\n", "").split("PB ")[0] + \
        "UNITS TDB\n"
    rm = _quiet(r_get_model, io.StringIO(text))
    pm = _quiet(get_model, io.StringIO(text), device=CPU)
    rt = _quiet(r_array, mjds, obs="gbt", freqs=1400.0, errors=1.0,
                ephem=rm.EPHEM.value)
    pt = _quiet(get_TOAs_array, mjds, obs="gbt", freqs=1400.0, errors=1.0,
                ephem=pm.EPHEM.value, device=CPU)
    want = np.asarray(rm.delay(rt))
    got = pm.delay(pt).numpy()
    assert np.max(np.abs(got - want)) <= DELAY_S


def _tim_rows(path):
    """(day, frac-dd, freqs, errors, obs, flags) of a written tim
    file."""
    from pint_tpu_torch.io.tim import parse_tim
    from pint_tpu_torch.time.mjd import parse_mjd_strings

    rows = parse_tim(str(path))
    day, frac = parse_mjd_strings([t.mjd_str for t in rows])
    return (day, frac, np.array([t.freq_mhz for t in rows]),
            np.array([t.error_us for t in rows]), [t.obs for t in rows],
            [dict(t.flags) for t in rows])


def test_zima_noise_draws(tmp_path, capsys):
    """zima with the white and the correlated draw from one seed: the
    same flags, errors and frequencies, TOAs within 1e-11 s."""
    par = tmp_path / "noisy.par"
    par.write_text(NOISY_PAR)
    (rc_r, out_r), (rc_p, out_p) = _both(
        tmp_path, capsys, "zima",
        lambda t: [str(par), str(tmp_path / f"{t}.tim"), "--ntoa", "40",
                   "--startMJD", "55100", "--duration", "300",
                   "--freq", "820", "--addnoise", "--addcorrnoise",
                   "--seed", "7"])
    assert rc_r == rc_p == 0
    assert out_p.replace("port.tim", "ref.tim") == out_r
    rd, rf, rfreq, rerr, robs, rflags = _tim_rows(tmp_path / "ref.tim")
    pd, pf, pfreq, perr, pobs, pflags = _tim_rows(tmp_path / "port.tim")
    assert np.array_equal(pd, rd) and np.array_equal(pfreq, rfreq)
    assert np.array_equal(perr, rerr) and pobs == robs and pflags == rflags
    ds = ((pf[0] - rf[0]) + (pf[1] - rf[1])) * 86400.0
    assert len(pd) == 40 and np.max(np.abs(ds)) <= ZIMA_S


def test_pintpublish_ngc6440e(capsys):
    """The LaTeX table of both packages' Fitter.auto fits of NGC6440E
    (publish_table on each fitter): equal line for line, except a
    fitted value whose last printed digit straddles a rounding
    boundary, which is compared as the fitted number, within 1e-3 of
    its uncertainty. The port's CLI prints its own table."""
    from pint_tpu.fitter import Fitter as RFitter
    from pint_tpu.models import get_model_and_toas as r_get
    from pint_tpu.scripts.pintpublish import publish_table as r_table
    from pint_tpu_torch.fitter import Fitter
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.scripts.pintpublish import main, publish_table

    rf = RFitter.auto(*reversed(_quiet(r_get, NGC_PAR, NGC_TIM)))
    pf = Fitter.auto(*reversed(_quiet(get_model_and_toas, NGC_PAR,
                                      NGC_TIM, device=CPU)))
    _quiet(rf.fit_toas)
    _quiet(pf.fit_toas)
    want = r_table(rf).splitlines()
    table = publish_table(pf)
    got = table.splitlines()
    assert len(got) == len(want) and r"\begin{tabular}" in table
    straddled = []
    for g, w in zip(got, want):
        if g == w:
            continue
        gk, wk = g.split(" & ", 1)[0], w.split(" & ", 1)[0]
        assert gk == wk, (g, w)
        nm = gk.split(" (")[0].replace(r"\_", "_")
        assert nm in pf.model.free_params, (g, w)
        rp, pp = rf.model.get_param(nm), pf.model.get_param(nm)
        assert abs(pp.value - rp.value) <= PUB_SIGMA * rp.uncertainty, nm
        straddled.append(nm)
    assert len(straddled) <= 2, straddled
    rc, out = _run(main, [NGC_PAR, NGC_TIM, "--device", CPU], capsys)
    assert rc == 0 and out == table
