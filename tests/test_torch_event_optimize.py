"""The port's event_optimize and fermiphase CLIs on the CPU
(pint_tpu_torch.scripts), against the reference's H-test on the same
events (tests/test_event_optimize.py's pulsar and photons)."""

import io
import json
import re
import warnings

import numpy as np
import pytest
import torch

import pint_tpu.eventstats as rstats
import pint_tpu_torch.eventstats as tstats
from pint_tpu.event_toas import get_event_weights as r_weights
from pint_tpu.event_toas import load_fits_TOAs as r_load_fits
from pint_tpu.models import get_model as r_get_model

from pint_tpu_torch.io.fits import write_events_fits
from pint_tpu_torch.models import get_model
from pint_tpu_torch.scripts import event_optimize, fermiphase, photonphase
from pint_tpu_torch.templates import make_template, write_template

from test_event_optimize import PAR, _write_pulsed_events

FERMI_MJDREF = (51910, 7.428703703703703e-4)


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evopt")
    ref = _quiet(r_get_model, io.StringIO(PAR))
    ev = tmp / "ev.fits"
    _write_pulsed_events(ev, ref)
    par = tmp / "m.par"
    par.write_text(ref.as_parfile())
    toas = _quiet(r_load_fits, str(ev), mission="nicer")
    phases = np.mod(np.asarray(ref.phase(toas).frac), 1.0)
    h0 = rstats.hmw(phases, r_weights(toas))
    return tmp, ev, par, h0


def run_cli(main, argv, capsys):
    rc = _quiet(main, [str(a) for a in argv])
    return rc, capsys.readouterr().out


def json_line(out, label):
    return json.loads(re.search(label + r": (\{.*\})", out).group(1))


def record_hmw(monkeypatch):
    """The H values the port's CLIs compute, in call order."""
    seen, real = [], tstats.hmw

    def hmw(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(tstats, "hmw", hmw)
    return seen


@pytest.mark.parametrize("with_template", [True, False])
def test_event_optimize_cli(files, capsys, monkeypatch, with_template):
    tmp, ev, par, h0 = files
    hs = record_hmw(monkeypatch)
    out_par = tmp / f"opt{with_template}.par"
    chains = tmp / f"chains{with_template}.npz"
    argv = [ev, par, "--mission", "nicer", "--nwalkers", "8",
            "--nsteps", "40", "--seed", "5", "--outfile", out_par,
            "--chains-npz", chains, "--device", "cpu"]
    if with_template:
        tfile = tmp / "prof.txt"
        write_template(make_template([("gaussian", 0.8, 0.4, 0.02)],
                                     device="cpu"), str(tfile))
        argv += ["--template", tfile]
    rc, txt = run_cli(event_optimize.main, argv, capsys)
    assert rc == 0
    assert ("Read template" in txt) == with_template
    assert ("Template ML" in txt) != with_template
    assert "autocorr" in txt
    assert len(hs) == 2       # the initial and the final H-test
    assert hs[0] == pytest.approx(h0, rel=1e-9)
    assert f"initial Htest {hs[0]:.1f}" in txt
    assert f"Final Htest {hs[1]:.1f}" in txt
    assert hs[1] > 0.5 * h0
    stages = json_line(txt, "Stage seconds")
    assert stages["device"] == "cpu"
    assert set(stages) >= {"ingest", "template", "mcmc", "htest", "total"}
    m2 = _quiet(get_model, str(out_par), device="cpu")
    assert m2.F0.value == pytest.approx(205.53069927, abs=5e-7)
    d = np.load(chains)
    assert d["chain"].shape == (40, 8, 1)
    assert d["lnprob"].shape == (40, 8)
    assert list(d["labels"]) == ["F0"]
    assert d["tau"].shape == (1,)


def test_event_optimize_defaults_to_cuda(files):
    _, ev, par, _ = files
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _quiet(event_optimize.main, [str(ev), str(par), "--nsteps", "2"])


def test_fermiphase_is_photonphase_for_fermi(files, capsys, monkeypatch):
    """fermiphase == photonphase --mission fermi --weightcol
    MODEL_WEIGHT on a Fermi-LAT-like FT1 file: the same phases and H."""
    tmp, _, par, _ = files
    rng = np.random.default_rng(4)
    n = 1200
    f0, pep = 205.53069927, 56500.0
    base = rng.uniform(56450.0, 56550.0, n)
    pulsed = rng.uniform(size=n) < 0.6
    phi = np.where(pulsed, np.mod(0.3 + 0.02 * rng.standard_normal(n), 1),
                   rng.uniform(size=n))
    k = np.floor((base - pep) * 86400.0 * f0)
    mjd = pep + (k + phi) / f0 / 86400.0
    times = ((mjd - FERMI_MJDREF[0]) - FERMI_MJDREF[1]) * 86400.0
    w = np.where(pulsed, rng.uniform(0.5, 1.0, n), rng.uniform(0, 0.5, n))
    order = np.argsort(times)
    ft1 = tmp / "ft1.fits"
    write_events_fits(str(ft1), {"TIME": times[order],
                                 "MODEL_WEIGHT": w[order]}, header_extra={
        "TIMESYS": "TDB", "TIMEREF": "SOLARSYSTEM", "TELESCOP": "GLAST",
        "MJDREFI": FERMI_MJDREF[0], "MJDREFF": FERMI_MJDREF[1],
        "TIMEZERO": 0.0, "TIMEUNIT": "s"})
    hs = record_hmw(monkeypatch)
    outs = []
    for main, extra in ((fermiphase.main, []),
                        (photonphase.main, ["--mission", "fermi",
                                            "--weightcol", "MODEL_WEIGHT"])):
        npz = tmp / f"{main.__module__.rsplit('.', 1)[-1]}.npz"
        rc, txt = run_cli(main, [ft1, par, "--device", "cpu", "--npz", npz]
                          + extra, capsys)
        assert rc == 0
        outs.append((re.search(r"Htest.*", txt).group(0), np.load(npz)))
    (h_a, d_a), (h_b, d_b) = outs
    assert h_a == h_b and "(weighted)" in h_a
    assert len(hs) == 2 and hs[0] == hs[1] > 25.0
    np.testing.assert_array_equal(d_a["phases"], d_b["phases"])
    np.testing.assert_array_equal(d_a["weights"], d_b["weights"])
