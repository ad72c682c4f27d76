"""The port's polycos (pint_tpu_torch.polycos) against the reference on
the CPU: blocks generated from the same model reproduce the port's full
phase chain to sub-microturn inside their spans, agree with the
reference's blocks, give the spin frequency of d_phase_d_toa, and
round-trip through the TEMPO file format, read by either package
(oracle: tests/test_polycos.py). The reference runs eagerly
(``jax.disable_jit()``), as in test_torch_binary.py: its compiled phase
contracts the dd transforms into FMAs, which moves the isolated model's
block coefficients by ~1.5e-8 turns at the block edge (~2e-10 turns of
phase) and the binary model's phase by ~1e-6 turns."""

import io
import warnings

import jax
import numpy as np
import pytest

from pint_tpu.models import get_model as r_get_model
from pint_tpu.polycos import Polycos as RPolycos
from pint_tpu_torch.models import get_model
from pint_tpu_torch.polycos import PolycoEntry, Polycos
from pint_tpu_torch.toa import get_TOAs_array

CPU = "cpu"
SPAN = (55000.0, 55000.25)

# tests/test_polycos.py's isolated pulsar
ISOLATED = """PSR J1234+56
RAJ 12:34:00.0
DECJ 56:00:00.0
F0 218.811843796
F1 -4.08e-16
PEPOCH 55000
DM 15.99
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""
# the same pulsar in a 0.25-day ELL1 orbit: the orbital Doppler is the
# hard case of a one-hour block
BINARY = ISOLATED + """BINARY ELL1
PB 0.25
A1 1.2
TASC 55000.01
EPS1 1e-5
EPS2 -2e-5
"""
PARS = {"isolated": ISOLATED, "binary": BINARY}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.fixture(scope="module", params=sorted(PARS))
def pair(request):
    """(name, ref model, ref polycos, port model, port polycos)."""
    name = request.param
    rm = _quiet(r_get_model, io.StringIO(PARS[name]))
    pm = _quiet(get_model, io.StringIO(PARS[name]), device=CPU)
    kw = dict(seg_length_min=60.0, ncoeff=12, obsfreq_mhz=1400.0)
    with jax.disable_jit():
        rp = RPolycos.generate_polycos(rm, *SPAN, "gbt", **kw)
    pp = Polycos.generate_polycos(pm, *SPAN, "gbt", **kw)
    return name, rm, rp, pm, pp


def _dphase(a, b):
    d = (a[0] + a[1]) - (b[0] + b[1])
    return np.abs(d - np.round(d))


def coeff_turns(a, b) -> float:
    """The largest difference of two blocks' coefficients, each as the
    turns its term moves at the block's edge (|dc_k| (span/2)^k)."""
    out = 0.0
    for ea, eb in zip(a.entries, b.entries):
        half = ea.span_min / 2.0
        scale = half ** np.arange(len(ea.coeffs))
        out = max(out, float(np.max(np.abs(ea.coeffs - eb.coeffs)
                                    * scale)))
        assert (ea.rphase_int, ea.tmid, ea.f0) == \
            (eb.rphase_int, eb.tmid, eb.f0)
    return out


def test_polycos_match_the_port_full_chain(pair):
    """Random epochs inside the span: the polyco phase equals the port's
    model.phase to under 1e-6 turns mod 1 (the TEMPO folding
    requirement of tests/test_polycos.py)."""
    name, _, _, pm, pp = pair
    assert len(pp.entries) == 6
    mjds = np.sort(np.random.default_rng(0).uniform(SPAN[0] + 0.003,
                                                    SPAN[1] - 0.003, 40))
    toas = _quiet(get_TOAs_array, mjds, obs="gbt", freqs=1400.0,
                  errors=1.0, device=CPU)
    ph = pm.phase(toas, abs_phase=True)
    full = (ph.int.numpy(), ph.frac.numpy())
    assert np.max(_dphase(pp.eval_abs_phase(mjds), full)) < 1e-6


def test_polycos_match_the_reference_blocks(pair):
    """The port's blocks are the eager reference's: the same segments,
    integer phases and frequencies, coefficients within 1e-12 turns at
    the block edge, and phases at random epochs within 1e-12 turns."""
    name, _, rp, _, pp = pair
    assert coeff_turns(pp, rp) <= 1e-12
    mjds = np.random.default_rng(1).uniform(*SPAN, 64)
    assert np.max(_dphase(pp.eval_abs_phase(mjds),
                          rp.eval_abs_phase(mjds))) <= 1e-12
    np.testing.assert_allclose(pp.eval_spin_freq(mjds),
                               rp.eval_spin_freq(mjds), rtol=1e-13)


def test_polycos_spin_freq_is_d_phase_d_toa(pair):
    """eval_spin_freq equals the full-pipeline d_phase_d_toa of the port
    to rtol 1e-9, and the topocentric (and orbital) Doppler is there."""
    name, _, _, pm, pp = pair
    mjds = np.linspace(SPAN[0] + 0.02, SPAN[1] - 0.02, 9)
    toas = _quiet(get_TOAs_array, mjds, obs="gbt", freqs=1400.0,
                  errors=1.0, device=CPU)
    f_full = pm.d_phase_d_toa(toas)
    np.testing.assert_allclose(pp.eval_spin_freq(mjds), f_full, rtol=1e-9)
    assert np.ptp(f_full) / 218.8 > (1e-5 if name == "binary" else 1e-7)


def test_polyco_file_round_trip_across_packages(pair, tmp_path):
    """The TEMPO file the port writes reads back in either package to
    under 5e-6 turns (RPHASE carries 6 decimals), and the reference's
    file reads back in the port to the same."""
    _, _, rp, _, pp = pair
    mjds = np.linspace(SPAN[0] + 0.01, SPAN[1] - 0.01, 25)
    pp.write_polyco_file(str(tmp_path / "port.dat"))
    rp.write_polyco_file(str(tmp_path / "ref.dat"))
    for back in (Polycos.read_polyco_file(str(tmp_path / "port.dat")),
                 RPolycos.read_polyco_file(str(tmp_path / "port.dat"))):
        assert len(back.entries) == len(pp.entries)
        assert np.max(_dphase(back.eval_abs_phase(mjds),
                              pp.eval_abs_phase(mjds))) < 5e-6
        np.testing.assert_allclose(back.eval_spin_freq(mjds),
                                   pp.eval_spin_freq(mjds), rtol=1e-12)
    back = Polycos.read_polyco_file(str(tmp_path / "ref.dat"))
    assert np.max(_dphase(back.eval_abs_phase(mjds),
                          rp.eval_abs_phase(mjds))) < 5e-6


def test_reference_entries_evaluate_bitwise_in_the_port(pair):
    """A PolycoEntry is plain numpy: the reference's entries, carried
    across field by field, evaluate bitwise as in the reference."""
    _, _, rp, _, _ = pair
    carried = Polycos([PolycoEntry(**vars(e)) for e in rp.entries])
    mjds = np.random.default_rng(2).uniform(*SPAN, 32)
    for a, b in zip(carried.eval_abs_phase(mjds), rp.eval_abs_phase(mjds)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(carried.eval_spin_freq(mjds),
                                  rp.eval_spin_freq(mjds))
