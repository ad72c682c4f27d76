"""The photon slice of the port (pint_tpu_torch) against the reference
pint_tpu on the CPU: TOA ingestion, parameter packing, the dd phase chain,
the H-test statistics, the photonphase CLI, and the port's own rules
(no jax, no pint_tpu, no quiet CPU fallback)."""

import ast
import io
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from test_events import _write_pulsed_events

import pint_tpu.eventstats as rstats
from pint_tpu.event_toas import get_event_weights as r_weights
from pint_tpu.event_toas import load_fits_TOAs as r_load_fits
from pint_tpu.models import get_model as r_get_model
from pint_tpu.toa import get_TOAs_array as r_get_toas_array

import pint_tpu_torch.eventstats as tstats
from pint_tpu_torch.event_toas import get_event_weights, load_fits_TOAs
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import batch_from_numpy, \
    params_from_packed
from pint_tpu_torch.toa import get_TOAs_array

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"

PAR = """
PSR J0030+0451
RAJ 00:30:27.4
DECJ 04:51:39.7
F0 205.53069927
F1 -4.3e-16
PEPOCH 56500
POSEPOCH 56500
DM 4.33
DMEPOCH 56500
TZRMJD 56500.0
TZRSITE @
TZRFRQ inf
UNITS TDB
"""
# the same isolated MSP with proper motion and parallax
PAR_PM = PAR + "PMRA 5.0\nPMDEC -2.0\nPX 3.3\n"
PARS = {"base": PAR, "pm_px": PAR_PM}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.fixture(scope="module", params=sorted(PARS))
def models(request):
    par = PARS[request.param]
    return (_quiet(r_get_model, io.StringIO(par)),
            _quiet(get_model, io.StringIO(par), device=CPU))


@pytest.fixture(scope="module")
def event_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ev") / "events.fits"
    ref = _quiet(r_get_model, io.StringIO(PAR))
    _write_pulsed_events(path, ref, n=1500, weights=True)
    return path


def _leaves(batch):
    """{leaf: numpy} of a reference or port ToaBatch (tdb_frac split)."""
    out = {}
    for k in batch._fields:
        v = getattr(batch, k)
        if k == "tdb_frac":
            out["tdb_frac_hi"], out["tdb_frac_lo"] = (
                np.asarray(v.hi.cpu() if torch.is_tensor(v.hi) else v.hi),
                np.asarray(v.lo.cpu() if torch.is_tensor(v.lo) else v.lo))
        else:
            out[k] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
    return out


def _assert_batches_bitwise(rb, tb):
    r, t = _leaves(rb), _leaves(tb)
    assert r.keys() == t.keys()
    for k in r:
        assert r[k].dtype == t[k].dtype == np.float64, k
        assert r[k].shape == t[k].shape, k
        assert np.array_equal(r[k].view(np.int64), t[k].view(np.int64)), k


def _circ(a, b):
    d = np.mod(np.asarray(a) - np.asarray(b), 1.0)
    return np.minimum(d, 1.0 - d)


# ------------------------------------------------------- TOA ingestion


def test_event_batch_bitwise(event_file):
    rt = _quiet(r_load_fits, event_file, weightcolumn="WEIGHT")
    tt = load_fits_TOAs(event_file, weightcolumn="WEIGHT", device=CPU)
    assert tt.ntoas == rt.ntoas == 1500
    assert all(o == "barycenter" for o in tt.obs)
    _assert_batches_bitwise(rt.to_batch(), tt.to_batch())
    # the weights: the reference's 8-significant-digit flag values
    w_ref, w = r_weights(rt), get_event_weights(tt)
    assert np.array_equal(w_ref, w)


@pytest.mark.parametrize("site,freq", [("@", np.inf), ("gbt", 1400.0)])
def test_tzr_and_site_batches_bitwise(site, freq):
    mjd = (np.array([56500.0, 57123.0]),
           (np.array([0.25, 0.123456789]), np.array([0.0, 1e-17])))
    rt = _quiet(r_get_toas_array, mjd, obs=site, freqs=freq, errors=1.0)
    tt = _quiet(get_TOAs_array, mjd, obs=site, freqs=freq, errors=1.0,
                device=CPU)
    _assert_batches_bitwise(rt.to_batch(), tt.to_batch())


def test_batch_is_one_buffer_on_the_device(event_file):
    tt = load_fits_TOAs(event_file, device=CPU)
    b = tt.to_batch()
    ptrs = {t.untyped_storage().data_ptr() for t in
            (b.tdb_day, b.tdb_frac.hi, b.ssb_obs_pos, b.pulse_number)}
    assert len(ptrs) == 1 and all(
        t.is_contiguous() and t.dtype == torch.float64 for t in
        (b.tdb_day, b.tdb_frac.lo, b.ssb_obs_vel, b.obs_sun_pos))


# ------------------------------------------------------ model building


def test_packed_params_bitwise(models):
    ref, port = models
    rp, tp = ref._pack(), port._pack()
    assert rp[0] == tp[0] and rp[1] == tp[1]
    for a, b in zip(rp[2:], tp[2:]):
        assert np.array_equal(np.asarray(a).view(np.int64),
                              np.asarray(b).view(np.int64))
    assert sorted(port.components) == sorted(ref.components)


# components the port has built since the refusal cases were written
PORTED_SINCE = ("FD", "ScaleDmError", "PLDMNoise", "DispersionJump",
                "WaveX", "Glitch", "SolarWindDispersion", "PLChromNoise",
                "ChromaticCM", "TroposphereDelay")


@pytest.mark.parametrize("line,owner", [
    ("FD1 1e-5", "FD"), ("WXSIN_0001 1e-6", "WaveX"),
    ("DMEFAC -f L 1.1", "ScaleDmError"), ("TNDMAMP -14", "PLDMNoise"),
    ("GLF0_1 1e-7", "Glitch"), ("NE_SW 7.9", "SolarWindDispersion"),
    ("DMJUMP -f L 0.1", "DispersionJump"), ("UNITS TCB", "TCB"),
    ("TNCHROMAMP -14", "PLChromNoise"), ("CM 0.1", "ChromaticCM"),
    ("CORRECT_TROPOSPHERE Y", "TroposphereDelay")])
def test_unported_components_refuse(line, owner):
    """A key of a component the port does not have raises, naming it;
    the key of one ported since lands on that component, as in the
    reference, or, where the line alone is an incomplete model (a glitch
    without its epoch, a chromatic amplitude without its index), raises
    the reference's error. ``UNITS TCB``, ported since too, is converted
    to TDB on load, to bitwise the reference's packed parameters."""
    if owner == "TCB":
        ref = _quiet(r_get_model, io.StringIO(PAR + line + "\n"))
        port = _quiet(get_model, io.StringIO(PAR + line + "\n"),
                      device=CPU)
        assert port.UNITS.value == ref.UNITS.value == "TDB"
        rp, tp = ref._pack(), port._pack()
        assert rp[:2] == tp[:2]
        for a, b in zip(rp[2:], tp[2:]):
            assert np.array_equal(np.asarray(a).view(np.int64),
                                  np.asarray(b).view(np.int64))
        return
    if owner in PORTED_SINCE:
        try:
            ref = _quiet(r_get_model, io.StringIO(PAR + line + "\n"))
        except ValueError as err:
            with pytest.raises(ValueError, match=re.escape(str(err))):
                _quiet(get_model, io.StringIO(PAR + line + "\n"),
                       device=CPU)
            return
        port = get_model(io.StringIO(PAR + line + "\n"), device=CPU)
        assert owner in port.components
        assert sorted(port.components) == sorted(ref.components)
        return
    with pytest.raises(NotImplementedError, match=owner):
        get_model(io.StringIO(PAR + line + "\n"), device=CPU)


@pytest.mark.parametrize("lines", [
    "DMX_0001 0.01 1\nDMXR1_0001 56000\nDMXR2_0001 57000",
    "EFAC -f L 1.1\nT2EFAC -f S 1.2\nEQUAD -f L 0.3\nT2EQUAD -f S 0.2"
    "\nTNEQ -f L -6.5",
    "ECORR -f L 1.2\nTNECORR -f S 0.7",
    "TNREDAMP -14\nTNREDGAM 3.1\nTNREDC 12",
    "RNAMP 0.02\nRNIDX -3.3",
    # binaries, with the BINARY line after its parameters once
    "BINARY ELL1\nPB 1.5 1\nA1 2.1 1\nTASC 56500.2 1\nEPS1 1e-5 1"
    "\nEPS2 -2e-6\nM2 0.2\nSINI 0.9 1",
    "FB0 7.7e-6 1\nFB1 -1e-19\nA1 2.1 1\nTASC 56500.2 1\nEPS1 1e-5"
    "\nEPS2 -2e-6\nBINARY ELL1",
    # the wideband families
    "DMJUMP -f L 0.1 1\nDMJUMP -fe R 3e-4\nDMEFAC -f L 1.1\n"
    "DMEQUAD -f S 2e-5",
    "TNDMAMP -13.5\nTNDMGAM 3.0\nTNDMC 20",
    "FD1 1e-5 1\nFD2 -2e-6 1\nFDJUMP -f L 1e-6 1\nFD2JUMP -f S 3e-7"])
def test_lifted_keys_build_the_reference_components(lines):
    """DMX windows, the EFAC/EQUAD/ECORR/red-noise families, the
    binaries (PB and FB-series orbits) and the wideband families (DMJUMP,
    DMEFAC/DMEQUAD, the DM noise, FD and FD jumps), which the port used
    to refuse,
    build the reference's components with bitwise the same packed values
    and the same TOA selections."""
    par = PAR + lines + "\n"
    ref = _quiet(r_get_model, io.StringIO(par))
    port = _quiet(get_model, io.StringIO(par), device=CPU)
    assert sorted(port.components) == sorted(ref.components)
    rp, tp = ref._pack(), port._pack()
    assert rp[:2] == tp[:2]
    for a, b in zip(rp[2:], tp[2:]):
        assert np.array_equal(np.asarray(a).view(np.int64),
                              np.asarray(b).view(np.int64))
    for name in ref.components:
        rc, tc = ref.components[name], port.components[name]
        assert list(tc.params) == list(rc.params), name
        for pn, rpar in rc.params.items():
            tpar = tc.params[pn]
            assert (tpar.value, tpar.frozen, tpar.units) == \
                (rpar.value, rpar.frozen, rpar.units), pn
            assert getattr(tpar, "key", None) == getattr(rpar, "key", None)
            assert tuple(getattr(tpar, "key_value", ())) == \
                tuple(getattr(rpar, "key_value", ()))


def test_unknown_keys_warn_and_are_ignored():
    with pytest.warns(UserWarning, match="NOTAPARAM"):
        m = get_model(io.StringIO(PAR + "NOTAPARAM 3\n"), device=CPU)
    assert m.unknown_params == ["NOTAPARAM"]


# --------------------------------------------------------- phase chain


@pytest.mark.parametrize("abs_phase", [True, False])
def test_phase_chain_from_converted_inputs(models, event_file, abs_phase):
    """The same packed parameters and batch leaves through both chains,
    without the port's parser or ingestion."""
    ref, port = models
    rt = _quiet(r_load_fits, event_file)
    rph = ref.phase(rt, abs_phase=abs_phase)
    rdelay = np.asarray(ref.delay(rt))
    pv = params_from_packed(*ref._pack(), device=CPU)
    rcache = ref.get_cache(rt)
    leaves = {k: np.asarray(v) for k, v in rcache["batch"]._asdict().items()
              if k != "tdb_frac"}
    leaves["tdb_frac"] = tuple(np.asarray(x)
                               for x in rcache["batch"].tdb_frac)
    cache = {"main": {}, "tzr": {}}
    if abs_phase:
        tz = rcache["tzr_batch"]
        tl = {k: np.asarray(v) for k, v in tz._asdict().items()
              if k != "tdb_frac"}
        tl["tdb_frac"] = tuple(np.asarray(x) for x in tz.tdb_frac)
        cache["tzr_batch"] = batch_from_numpy(tl, CPU)
    ph, delay = port.phase_fn(pv, batch_from_numpy(leaves, CPU), cache)
    from pint_tpu_torch.phase import Phase

    ph = Phase(ph)
    assert np.array_equal(np.asarray(rph.int), ph.int.numpy())
    assert np.max(np.abs(np.asarray(rph.frac) - ph.frac.numpy())) <= 1e-11
    assert np.max(np.abs(rdelay - delay.numpy())) <= 1e-12


@pytest.mark.parametrize("abs_phase", [True, False])
def test_phase_end_to_end_matches_reference(models, event_file, abs_phase):
    ref, port = models
    rt = _quiet(r_load_fits, event_file)
    tt = load_fits_TOAs(event_file, device=CPU)
    rph = ref.phase(rt, abs_phase=abs_phase)
    ph = port.phase(tt, abs_phase=abs_phase)
    assert ph.frac.dtype == torch.float64
    assert np.array_equal(np.asarray(rph.int), ph.int.numpy())
    assert np.max(np.abs(np.asarray(rph.frac) - ph.frac.numpy())) <= 1e-11
    assert np.max(np.abs(np.asarray(ref.delay(rt))
                         - port.delay(tt).numpy())) <= 1e-12


# every ported component at once: ecliptic astrometry with proper motion
# and parallax, a DM Taylor series, F2, a free F0/F1, PHOFF, an MJD-range
# JUMP, planets, and a TZR point at a ground site
ZOO_PAR = """
PSR J1234+5678
ELONG 123.456789012
ELAT -12.3456789
PMELONG 3.1
PMELAT -7.2
PX 1.2
ECL IERS2003
F0 61.485476554373152396 1
F1 -1.1813e-15 1
F2 2.7e-26
PEPOCH 55555.5
POSEPOCH 55555
DM 71.0186
DM1 -3e-4
DM2 1e-5
DMEPOCH 55500
PHOFF 0.125
JUMP MJD 55500 55600 1.7e-4
TZRMJD 55555.123456789012345
TZRSITE gbt
TZRFRQ 1410.0
PLANET_SHAPIRO Y
"""


@pytest.mark.parametrize("abs_phase", [True, False])
@pytest.mark.parametrize("site", ["gbt", "@"])
def test_component_zoo_phase_matches_reference(site, abs_phase):
    ref = _quiet(r_get_model, io.StringIO(ZOO_PAR))
    port = _quiet(get_model, io.StringIO(ZOO_PAR), device=CPU)
    assert sorted(port.components) == sorted(ref.components)
    rng = np.random.default_rng(3)
    mjd = np.sort(rng.uniform(55000, 56000, 300))
    freqs = rng.choice([820.0, 1400.0, 2300.0], 300)
    kw = dict(obs=site, freqs=freqs, errors=1.0, planets=True)
    rt = _quiet(r_get_toas_array, mjd, **kw)
    tt = _quiet(get_TOAs_array, mjd, device=CPU, **kw)
    _assert_batches_bitwise(rt.to_batch(), tt.to_batch())
    rph, ph = ref.phase(rt, abs_phase=abs_phase), port.phase(
        tt, abs_phase=abs_phase)
    assert np.array_equal(np.asarray(rph.int), ph.int.numpy())
    assert np.max(np.abs(np.asarray(rph.frac) - ph.frac.numpy())) <= 1e-11
    assert np.max(np.abs(np.asarray(ref.delay(rt))
                         - port.delay(tt).numpy())) <= 1e-12


# ---------------------------------------------------------- statistics


@pytest.mark.parametrize("stat", ["z2m", "hm", "hmw"])
@pytest.mark.parametrize("signal", [True, False])
def test_statistics_match_reference(stat, signal):
    rng = np.random.default_rng(7 if signal else 8)
    n = 4000
    ph = np.mod(0.3 + 0.03 * rng.standard_normal(n), 1.0) if signal \
        else rng.uniform(size=n)
    w = rng.uniform(0.05, 1.0, n)
    if stat == "z2m":
        r = rstats.z2m(ph, m=3, weights=w)
        t = tstats.z2m(ph, m=3, weights=w, device=CPU)
    elif stat == "hm":
        r, t = rstats.hm(ph), tstats.hm(ph, device=CPU)
    else:
        r, t = rstats.hmw(ph, w), tstats.hmw(ph, w, device=CPU)
    assert t == pytest.approx(r, rel=1e-9, abs=1e-9)


def test_significance_helpers_match_reference():
    for h in (3.0, 50.0, 3000.0):
        assert tstats.h_sig(h) == rstats.h_sig(h)
        assert tstats.h2sig(h) == rstats.h2sig(h)
        assert tstats.sf_hm(h) == rstats.sf_hm(h)
    assert tstats.sf_z2m(12.0, 2) == rstats.sf_z2m(12.0, 2)
    assert tstats.sig2sigma(1e-320) == rstats.sig2sigma(1e-320)


# ------------------------------------------------------ the whole slice


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    h = float(re.search(r"Htest.*?: (\S+)", out).group(1))
    return h, out


def test_photonphase_cli_matches_reference(tmp_path, capsys):
    """The tests/test_events.py test_photonphase_cli fixture through both
    CLIs."""
    from pint_tpu.scripts.photonphase import main as r_main
    from pint_tpu_torch.scripts.photonphase import main as t_main

    ref = _quiet(r_get_model, io.StringIO(PAR))
    ev = tmp_path / "events.fits"
    _write_pulsed_events(ev, ref, n=1200, frac_pulsed=0.8, width=0.02)
    par = tmp_path / "model.par"
    par.write_text(ref.as_parfile())
    outs = {}
    for tag, main, extra in (("ref", r_main, []),
                             ("port", t_main, ["--device", "cpu"])):
        npz = tmp_path / f"{tag}.npz"
        fits = tmp_path / f"{tag}.fits"
        h, out = _quiet(_run_cli, main, [str(ev), str(par), "--npz",
                                         str(npz), "--outfile", str(fits),
                                         *extra], capsys)
        outs[tag] = (h, np.load(npz)["phases"], out)
    assert outs["port"][0] == pytest.approx(outs["ref"][0], rel=1e-9)
    assert np.max(_circ(outs["port"][1], outs["ref"][1])) <= 1e-11
    assert "Stage seconds" in outs["port"][2]
    from pint_tpu_torch.io.fits import read_events_fits

    cols, _ = read_events_fits(tmp_path / "port.fits")
    assert np.array_equal(cols["PULSE_PHASE"], outs["port"][1])


# ------------------------------------------------------------- the rules


def _port_sources():
    files = sorted((REPO / "pint_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_reference():
    bad = []
    names = {str(f.relative_to(REPO)) for f in _port_sources()}
    # the fit, binary and wideband slices' modules are among those checked
    assert {"pint_tpu_torch/parallel/fit_step.py", "pint_tpu_torch/gls.py",
            "pint_tpu_torch/fitter.py", "pint_tpu_torch/residuals.py",
            "pint_tpu_torch/simulation.py", "pint_tpu_torch/models/noise.py",
            "pint_tpu_torch/scripts/pintempo.py", "chip_smoke.py",
            "pint_tpu_torch/models/binary.py", "pint_tpu_torch/wideband.py",
            "pint_tpu_torch/wideband_fitter.py",
            "pint_tpu_torch/models/components_extra.py",
            "pint_tpu_torch/models/components_tail.py",
            "pint_tpu_torch/models/dispersion.py"} <= names
    for f in _port_sources():
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                top = nm.split(".")[0]
                if top in ("jax", "jaxlib", "pint_tpu", "bench",
                           "__graft_entry__"):
                    bad.append(f"{f.relative_to(REPO)}:{node.lineno} {nm}")
    assert not bad, bad


def _entry_points(tmp_path, event_file):
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.parallel import build_fit_step
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.scripts import pintempo
    from pint_tpu_torch.scripts.photonphase import main
    from pint_tpu_torch.simulation import make_fake_toas_uniform
    from pint_tpu_torch.toa import get_TOAs

    par = tmp_path / "m.par"
    par.write_text(PAR)
    tim = REPO / "tests" / "datafile" / "NGC6440E.tim"
    ngc = REPO / "tests" / "datafile" / "NGC6440E.par"

    def cpu_fit_inputs():
        return (get_model(str(ngc), device=CPU),
                get_TOAs(str(tim), device=CPU))

    return {
        "get_TOAs": lambda: get_TOAs(str(tim)),
        "get_model_and_toas": lambda: get_model_and_toas(str(ngc),
                                                         str(tim)),
        "pintempo": lambda: pintempo.main([str(ngc), str(tim)]),
        # a model and TOAs made for the CPU, asked for the GPU
        "build_fit_step": lambda: build_fit_step(*cpu_fit_inputs(),
                                                 device="cuda"),
        "designmatrix": lambda: (lambda m, t: m.designmatrix(
            t, device="cuda"))(*cpu_fit_inputs()),
        "Residuals": lambda: Residuals(*cpu_fit_inputs()[::-1],
                                       device="cuda").time_resids,
        "make_fake_toas_uniform": lambda: make_fake_toas_uniform(
            56000, 56100, 4, cpu_fit_inputs()[0], device="cuda"),
        "get_model": lambda: get_model(io.StringIO(PAR)),
        "get_TOAs_array": lambda: get_TOAs_array(np.array([56500.0])),
        "load_fits_TOAs": lambda: load_fits_TOAs(event_file),
        "hmw": lambda: tstats.hmw(np.array([0.1, 0.2]), None),
        "z2m": lambda: tstats.z2m(np.array([0.1, 0.2])),
        "photonphase": lambda: main([str(event_file), str(par)]),
        # a model made for the CPU, asked for the GPU
        "TimingModel.phase": lambda: get_model(
            io.StringIO(PAR), device=CPU).phase(
            load_fits_TOAs(event_file, device=CPU), device="cuda"),
    }


@pytest.mark.parametrize("name", ["get_model", "get_TOAs_array",
                                  "load_fits_TOAs", "hmw", "z2m",
                                  "photonphase", "TimingModel.phase",
                                  "get_TOAs", "get_model_and_toas",
                                  "pintempo", "build_fit_step",
                                  "designmatrix", "Residuals",
                                  "make_fake_toas_uniform"])
def test_default_device_is_the_gpu_and_never_falls_back(
        name, tmp_path, event_file):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _quiet(_entry_points(tmp_path, event_file)[name])
