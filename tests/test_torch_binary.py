"""The binary slice of the port (pint_tpu_torch.models.binary and the
model builder's BINARY routing) against the reference pint_tpu on the
CPU: for every registered binary model, the components and packed
parameters, the par-file output, the delay and the phase (the design
matrix in test_torch_binary_design.py); the routing of ``BINARY T2``, of the model-name spellings, of
the FB series and of a parameter the selected model does not carry; and
``kepler_E`` with its jacfwd derivatives.

The reference is evaluated eagerly here (``jax.disable_jit()``). On the
CPU, XLA's compiled phase function of a binary model contracts the
double-double error-free transforms into fused multiply-adds: its phase
then differs from the same function run eagerly by ~1.4e-6 turns and its
delays by up to ~3e-12 s (with FMA unavailable, ``XLA_FLAGS=
--xla_cpu_max_isa=SSE4_2``, the two are equal). Eager, the reference's
dd arithmetic is exact, as the port's is, and the port is held to it."""

import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import get_model as r_get_model
from pint_tpu.models.binary import kepler_E as r_kepler_E
from pint_tpu.models.model_builder import guess_binary_model as r_guess
from pint_tpu.toa import get_TOAs_array as r_get_TOAs_array

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.binary import kepler_E
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.models.model_builder import T2BinaryWarning, \
    guess_binary_model

from test_torch_photon import _quiet

CPU = "cpu"
NTOA = 120

# a J1012+5307-like pulsar (tests/test_binary_zoo.py, tests/test_binary.py)
BASE = """PSR J1012+5307
RAJ 10:12:33.43 1
DECJ 53:07:02.5 1
PMRA 2.6 1
PMDEC -25.5 1
PX 1.2 1
F0 190.2678376220576 1
F1 -6.2e-16 1
PEPOCH 55000
POSEPOCH 55000
DM 9.02 1
DMEPOCH 55000
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""

# BINARY name -> orbit; every family with most of its parameters free
ORBITS = {
    "ELL1": "PB 0.60467271355 1\nA1 0.5818172 1\nTASC 55000.40712 1\n"
            "EPS1 1.2e-5 1\nEPS2 -3.4e-6 1\nM2 0.2 1\nSINI 0.9 1\n"
            "EPS1DOT 1e-16\nPBDOT 0.2\n",
    "ELL1_FB": "FB0 1.914e-5 1\nFB1 -1e-19\nA1 0.5818172 1\n"
               "TASC 55000.40712 1\nEPS1 1.2e-5 1\nEPS2 -3.4e-6 1\n",
    "ELL1H": "PB 0.60467271355 1\nA1 0.5818172 1\nTASC 55000.40712 1\n"
             "EPS1 1.2e-5 1\nEPS2 -3.4e-6 1\nH3 2.1e-7 1\nSTIG 0.6 1\n",
    "ELL1H_H3": "PB 0.60467271355 1\nA1 0.5818172 1\nTASC 55000.40712 1\n"
                "EPS1 1.2e-5 1\nEPS2 -3.4e-6 1\nH3 2.1e-7 1\n",
    "ELL1k": "PB 0.2 1\nA1 0.9 1\nTASC 55000.05 1\nEPS1 1.1e-5 1\n"
             "EPS2 -0.4e-5 1\nM2 0.2\nSINI 0.9\nOMDOT 1.5 1\nLNEDOT 1e-12\n",
    "BT": "PB 0.60467271355 1\nA1 0.5818172 1\nT0 55000.40712 1\n"
          "ECC 1.0e-5 1\nOM 45.0 1\nGAMMA 0.0\n",
    "BT_piecewise": "PB 1.2 1\nA1 3.5 1\nT0 55000.2 1\nECC 0.01 1\n"
                    "OM 40.0 1\nT0X_0001 55000.2002 1\nA1X_0001 3.5004 1\n"
                    "XR1_0001 54800\nXR2_0001 55200\n",
    "DD": "PB 0.6 1\nA1 1.45 1\nT0 55000.2 1\nECC 0.02 1\nOM 47.0 1\n"
          "GAMMA 1e-4 1\nM2 0.3 1\nSINI 0.95 1\nOMDOT 0.5\nA0 1e-7\n"
          "B0 2e-7\nEDOT 2e-16\n",
    "DDS": "PB 0.6 1\nA1 1.45 1\nT0 55000.2 1\nECC 0.02 1\nOM 47.0 1\n"
           "M2 0.3 1\nSHAPMAX 2.5 1\n",
    "DDH": "PB 0.6 1\nA1 1.45 1\nT0 55000.2 1\nECC 0.02 1\nOM 47.0 1\n"
           "H3 2.0e-7 1\nSTIG 0.7 1\n",
    "DDGR": "PB 0.4 1\nA1 2.34 1\nT0 55000.1 1\nECC 0.17 1\nOM 30.0 1\n"
            "MTOT 2.8 1\nM2 1.3 1\nXPBDOT 1e-14\n",
    "DDK": "PB 0.6 1\nA1 1.45 1\nT0 55000.2 1\nECC 0.02 1\nOM 47.0 1\n"
           "M2 0.3 1\nKIN 71.0 1\nKOM 35.0 1\n",
}


# cases whose BINARY name is not their key
BINARY_NAME = {"ELL1_FB": "ELL1", "ELL1H_H3": "ELL1H"}


def binary_par(case: str) -> str:
    return BASE + f"BINARY {BINARY_NAME.get(case, case)}\n" + ORBITS[case]


@pytest.fixture(scope="module", params=sorted(ORBITS))
def binary(request):
    """(case, reference model, port model, reference TOAs, port TOAs):
    NTOA TOAs at GBT (so the K95 terms of DDK see a real observatory
    position) over MJD 54100-55900, at 1400 and 820 MHz."""
    par = binary_par(request.param)
    rng = np.random.default_rng(7)
    mjds = np.sort(rng.uniform(54100.0, 55900.0, NTOA))
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    rt = _quiet(r_get_TOAs_array, mjds, obs="gbt",
                freqs=np.tile([1400.0, 820.0], NTOA // 2), errors=1.0)
    return request.param, rm, tm, rt, toas_from_columns(rt, CPU)


def _bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


def _assert_models_equal(rm, tm):
    assert sorted(tm.components) == sorted(rm.components)
    rp, tp = rm._pack(), tm._pack()
    assert rp[:2] == tp[:2]
    assert all(_bitwise(a, b) for a, b in zip(rp[2:], tp[2:]))
    for name, rc in rm.components.items():
        tc = tm.components[name]
        assert list(tc.params) == list(rc.params), name
        for pn, rpar in rc.params.items():
            tpar = tc.params[pn]
            assert (tpar.value, tpar.frozen, tpar.units,
                    tpar.uncertainty) == \
                (rpar.value, rpar.frozen, rpar.units, rpar.uncertainty), pn


# --------------------------------------------------------------- models


def test_components_and_packed_params_bitwise(binary):
    _, rm, tm, _, _ = binary
    _assert_models_equal(rm, tm)
    assert sum(c.startswith("Binary") for c in tm.components) == 1
    assert tm.BINARY == rm.BINARY


def test_parfile_round_trip(binary):
    """as_parfile is the reference's text, BINARY line first, and both
    packages build the same model from it again."""
    _, rm, tm, _, _ = binary
    text = tm.as_parfile()
    assert text == rm.as_parfile()
    assert text.splitlines()[0].split()[0] == "BINARY"
    again = _quiet(get_model, io.StringIO(text), device=CPU)
    r_again = _quiet(r_get_model, io.StringIO(text))
    _assert_models_equal(r_again, again)
    assert again.as_parfile() == r_again.as_parfile()


# -------------------------------------------------------------- physics


def test_delay_and_phase_match_reference(binary):
    """Per-TOA total delay (binary last in the chain) within 1e-12 s,
    the absolute phase (TZR row through the binary too) with equal pulse
    numbers and fractions within 1e-11 turns."""
    _, rm, tm, rt, tt = binary
    with jax.disable_jit():
        rd = np.asarray(rm.delay(rt))
        rph = rm.phase(rt)
    td, tph = tm.delay(tt), tm.phase(tt)
    assert td.dtype == torch.float64
    assert np.max(np.abs(rd - td.numpy())) <= 1e-12
    assert np.array_equal(np.asarray(rph.int), tph.int.numpy())
    assert np.max(np.abs(np.asarray(rph.frac) - tph.frac.numpy())) <= 1e-11


# -------------------------------------------------------------- routing


T2_PAR = BASE + "BINARY T2\nPB 0.6 1\nA1 1.45 1\n"
T2_FAMILIES = {
    "BT": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\n",
    "DD": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\nM2 0.3 1\nSINI 0.95 1\n",
    "DDS": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\nM2 0.3\nSHAPMAX 2.5 1\n",
    "DDH": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\nH3 2e-7 1\nSTIG 0.7\n",
    "DDGR": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\nMTOT 2.8 1\nM2 1.3\n",
    # T2's KIN/KOM are IAU-convention: DDK gets 180-KIN and 90-KOM; the
    # stray SINI (DDK takes the inclination from KIN) is dropped
    "DDK": "T0 55000.2 1\nECC 0.02 1\nOM 47.0 1\nM2 0.3\nKIN 137.56 1\n"
           "KOM 207.0 1\nSINI 0.674 1\n",
    "ELL1": "TASC 55000.1 1\nEPS1 1.2e-6 1\nEPS2 -3e-7 1\n",
    "ELL1H": "TASC 55000.1 1\nEPS1 1.2e-6 1\nEPS2 -3e-7 1\nH3 2e-7 1\n",
    "ELL1k": "TASC 55000.1 1\nEPS1 1.2e-6 1\nEPS2 -3e-7 1\nLNEDOT 0.0\n",
}


@pytest.mark.parametrize("family", sorted(T2_FAMILIES))
def test_t2_routes_like_the_reference(family):
    par = T2_PAR + T2_FAMILIES[family]
    with pytest.warns(T2BinaryWarning, match=family):
        tm = get_model(io.StringIO(par), device=CPU)
    rm = _quiet(r_get_model, io.StringIO(par))
    assert f"Binary{family}" in tm.components
    _assert_models_equal(rm, tm)
    assert tm.BINARY == rm.BINARY == family
    assert tm.unknown_params == rm.unknown_params
    if family == "DDK":
        assert tm.KIN.value == 180.0 - 137.56
        assert tm.KOM.value == 90.0 - 207.0
        assert tm.unknown_params == ["SINI"]


@pytest.mark.parametrize("keys", [
    "PB A1 T0 ECC OM", "PB A1 T0 ECC OM M2 SINI", "PB A1 T0 ECC OM GAMMA",
    "PB A1 T0 ECC OM SHAPMAX", "PB A1 T0 ECC OM MTOT",
    "PB A1 T0 ECC OM H3 STIG", "PB A1 T0 ECC OM KIN KOM",
    "PB A1 TASC EPS1 EPS2", "PB A1 TASC EPS1 EPS2 H3",
    "PB A1 TASC EPS1 EPS2 LNEDOT", "PB A1 TASC EPS1 KIN"])
def test_guess_binary_model_matches_reference(keys):
    assert guess_binary_model(keys.split()) == r_guess(keys.split())


@pytest.mark.parametrize("name", ["BT_piecewise", "BTPiecewise",
                                  "bt_piecewise", "ELL1K", "ell1", "Dd"])
def test_model_name_ignores_case_and_underscores(name):
    orbit = ORBITS["BT_piecewise"] if name.upper().startswith("BT") else \
        ORBITS["ELL1k"] if name.upper() == "ELL1K" else \
        ORBITS["ELL1"] if name.upper() == "ELL1" else ORBITS["DD"]
    par = BASE + f"BINARY {name}\n" + orbit
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    _assert_models_equal(rm, tm)
    assert tm.BINARY == rm.BINARY == name
    assert tm.as_parfile() == rm.as_parfile()


def test_parameter_the_selected_model_lacks_is_refused_alike():
    """A binary parameter of another family (T0 and OM in an ELL1 par)
    builds no second binary: both packages warn with their
    UnknownParameterWarning and ignore it; an unknown model raises."""
    par = BASE + "BINARY ELL1\n" + ORBITS["ELL1"] + "T0 55000.2\nOM 3.0\n"
    caught = {}
    for tag, fn, kw in (("ref", r_get_model, {}),
                        ("port", get_model, {"device": CPU})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m = fn(io.StringIO(par), **kw)
        caught[tag] = (m, sorted({type(x.message).__name__ for x in w}))
    (rm, rw), (tm, tw) = caught["ref"], caught["port"]
    assert tw == rw and "UnknownParameterWarning" in tw
    assert tm.unknown_params == rm.unknown_params == ["OM", "T0"]
    _assert_models_equal(rm, tm)
    for fn, kw in ((r_get_model, {}), (get_model, {"device": CPU})):
        with pytest.raises(NotImplementedError, match="FOO"):
            _quiet(fn, io.StringIO(BASE + "BINARY FOO\nPB 1.0\n"), **kw)


# --------------------------------------------------------------- Kepler


def test_kepler_E_and_its_jacfwd_match_reference():
    """The fixed 10-step Newton unroll on a grid of mean anomalies and
    eccentricities up to 0.9: E within 1e-14 rad of the reference's and
    solving Kepler's equation, and jacfwd's dE/dM and dE/de (through
    the steps) within 1e-12 relative of jax.jacfwd's."""
    M = np.linspace(-np.pi, np.pi, 41)
    for e in (0.0, 1e-5, 0.02, 0.17, 0.5, 0.9):
        E = kepler_E(torch.as_tensor(M), torch.tensor(e, dtype=torch.float64))
        rE = np.asarray(r_kepler_E(jnp.asarray(M), jnp.asarray(e)))
        assert np.max(np.abs(E.numpy() - rE)) <= 1e-14, e
        assert np.max(np.abs(E.numpy() - e * np.sin(E.numpy()) - M)) <= 1e-13
        for arg in (0, 1):
            def f(m, ecc):
                return kepler_E(m, ecc)

            def rf(m, ecc):
                return r_kepler_E(m, ecc)

            for m_i in (0, 7, 20, 33):
                x = (torch.tensor(M[m_i], dtype=torch.float64),
                     torch.tensor(e, dtype=torch.float64))
                d = torch.func.jacfwd(f, argnums=arg)(*x).item()
                rd = float(jax.jacfwd(rf, argnums=arg)(
                    jnp.asarray(M[m_i]), jnp.asarray(e)))
                assert abs(d - rd) <= 1e-12 * max(abs(rd), 1.0), (e, arg)
