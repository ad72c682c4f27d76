"""The port's TCB <-> TDB conversion (pint_tpu_torch.models.
tcb_conversion and get_model's UNITS TCB handling) against the reference
on the CPU (oracles: tests/test_cli_utils.py's TCB cases and
tests/test_model.py::test_tcb_converted_by_default_refused_on_request).
The conversion is host dd parameter algebra copied from the reference,
so converted parameters are bitwise the reference's; a model written in
TCB and read back converted gives the original's phase on the port to
the tolerance stated."""

import io
import warnings

import numpy as np
import pytest

from pint_tpu.models import get_model as r_get_model
from pint_tpu.models.tcb_conversion import convert_tcb_tdb as r_convert
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.tcb_conversion import (
    IFTE_K,
    T0_MJD,
    convert_tcb_tdb,
)

from test_torch_host_api import _fake_pair, _quiet

CPU = "cpu"

# tests/test_cli_utils.py's pulsar
CLI = """PSR J0012+0012
RAJ 03:30:00.0 1
DECJ 22:00:00.0 1
F0 312.0 1
F1 -4e-15 1
PEPOCH 55500
POSEPOCH 55500
DM 21.0 1
DMEPOCH 55500
TZRMJD 55500.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""
# an ELL1 binary with DMX windows, a JUMP, noise and a 20-digit F0:
# epochs, prefix families, mask parameters and a dd value
BINARY = CLI.replace("F0 312.0 1", "F0 312.12345678901234567 1") + """\
BINARY ELL1
PB 1.2 1
A1 2.0 1
TASC 55500.1 1
EPS1 1e-5 1
EPS2 2e-5
M2 0.25
SINI 0.92
DMX_0001 1e-3 1
DMXR1_0001 55000
DMXR2_0001 55400
JUMP -fe L 1e-6 1
EFAC -be X 1.1
EQUAD -be X 0.3
"""
PARS = {"cli": CLI, "binary": BINARY}


def _params(model):
    """{name: (value, dd pair, uncertainty, frozen)} of every parameter."""
    out = {}
    for c in model.components.values():
        for n, p in c.params.items():
            out[n] = (p.value, getattr(p, "_dd", None), p.uncertainty,
                      p.frozen)
    return out


@pytest.mark.parametrize("name", sorted(PARS))
@pytest.mark.parametrize("backwards", [True, False])
def test_conversion_is_bitwise_the_reference(name, backwards):
    """Both directions give the reference's parameters bit for bit
    (values, dd pairs, uncertainties), its UNITS, and its warning."""
    rm = _quiet(r_get_model, io.StringIO(PARS[name]))
    pm = _quiet(get_model, io.StringIO(PARS[name]), device=CPU)
    if not backwards:
        rm, pm = r_convert(rm, backwards=True), \
            convert_tcb_tdb(pm, backwards=True)
    with warnings.catch_warnings(record=True) as rw:
        warnings.simplefilter("always")
        want = r_convert(rm, backwards=backwards)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = convert_tcb_tdb(pm, backwards=backwards)
    assert [str(w.message) for w in pw] == [str(w.message) for w in rw]
    assert got.UNITS.value == want.UNITS.value
    assert got.device == pm.device and got is not pm
    assert _params(got) == _params(want)
    with pytest.raises(ValueError, match="expected"):
        convert_tcb_tdb(got, backwards=backwards)


def test_round_trip_limits_of_the_reference():
    """tests/test_cli_utils.py::test_tcb_conversion_roundtrip on the port:
    F0 scales down by IFTE_K (1e-15 relative), DM up, PEPOCH maps
    through the fixed point (1e-8 d); back to TDB, F0 to 1e-15 relative
    and PEPOCH to 1e-9 d."""
    m = _quiet(get_model, io.StringIO(CLI), device=CPU)
    m_tcb = convert_tcb_tdb(m, backwards=True)
    assert m_tcb.UNITS.value == "TCB"
    assert m_tcb.F0.value < m.F0.value
    assert m_tcb.F0.value == pytest.approx(m.F0.value / IFTE_K, rel=1e-15)
    assert m_tcb.DM.value > m.DM.value
    assert m_tcb.PEPOCH.value == pytest.approx(
        T0_MJD + (m.PEPOCH.value - T0_MJD) * IFTE_K, abs=1e-8)
    back = convert_tcb_tdb(m_tcb)
    assert back.F0.value == pytest.approx(m.F0.value, rel=1e-15)
    assert back.PEPOCH.value == pytest.approx(m.PEPOCH.value, abs=1e-9)


@pytest.mark.parametrize("name", sorted(PARS))
def test_get_model_converts_tcb_like_the_reference(name):
    """A UNITS TCB par file is converted on load, with the reference's
    warning, to bitwise the reference's model; allow_tcb=False raises
    the reference's ValueError."""
    text = PARS[name].replace("UNITS TDB", "UNITS TCB")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = get_model(io.StringIO(text), device=CPU)
    assert got.UNITS.value == "TDB"
    assert any("TCB" in str(x.message) for x in w)
    want = _quiet(r_get_model, io.StringIO(text))
    assert _params(got) == _params(want)
    for get in (get_model, r_get_model):
        kw = {"device": CPU} if get is get_model else {}
        with pytest.raises(ValueError, match="TCB"):
            get(io.StringIO(text), allow_tcb=False, **kw)


@pytest.mark.parametrize("name", sorted(PARS))
def test_tcb_par_file_reads_back_to_the_same_phase(name):
    """The model written as UNITS TCB (convert_tcb_tdb(backwards=True),
    as_parfile) and read back by get_model gives the original's phase:
    to 1e-9 turns, far inside what test_tcb_conversion_roundtrip's F0
    limit allows (1e-15 F0 over 1,000 days is ~3e-5 turns)."""
    rm, rt, pm, pt = _fake_pair(PARS[name], n=24, seed=6)
    text = convert_tcb_tdb(pm, backwards=True).as_parfile()
    assert "TCB" in text
    back = _quiet(get_model, io.StringIO(text), device=CPU)
    p0, p1 = pm.phase(pt), back.phase(pt)
    d = (p1.turns.hi - p0.turns.hi) + (p1.turns.lo - p0.turns.lo)
    assert float(d.abs().max()) <= 1e-9
    assert np.array_equal(p0.int.numpy(), p1.int.numpy())
