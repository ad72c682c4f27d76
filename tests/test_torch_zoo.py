"""The rest of the timing-model zoo in the port (pint_tpu_torch.models:
Glitch, Wave, WaveX, DMWaveX, SolarWindDispersion, TroposphereDelay,
ChromaticCM, ChromaticCMX, CMWaveX, IFunc, PiecewiseSpindown,
SolarWindDispersionX, PLChromNoise, PLSWNoise) against the reference
pint_tpu on the CPU, one component at a time on an isolated
J1012+5307-like pulsar: the components and packed parameters, the
par-file output, the delay and the phase, the noise bases; the design
matrix is in test_torch_zoo_design.py.

The reference runs eagerly (``jax.disable_jit()``), as in
test_torch_binary.py. Its index families loop over the indices in
Python, the port's are one (N, K) tensor op with one reduction: the
sums are held to a tolerance, not bit for bit. Delays within 1e-12 s,
phases within 1e-12 turns with equal pulse numbers, noise bases and
weights within 1e-15 of their largest entry."""

import io
import warnings

import jax
import numpy as np
import pytest

from pint_tpu.models import get_model as r_get_model
from pint_tpu.toa import get_TOAs_array as r_get_TOAs_array

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns

from test_torch_binary import _assert_models_equal
from test_torch_photon import _quiet

CPU = "cpu"
NTOA = 120
DELAY_S, PHASE_TURNS, NOISE_REL = 1e-12, 1e-12, 1e-15

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

# component -> par lines; each family with a few indices, most free
ZOO = {
    "Glitch": "GLEP_1 54600\nGLPH_1 0.1 1\nGLF0_1 1e-8 1\nGLF1_1 -1e-17 1"
              "\nGLF0D_1 2e-8 1\nGLTD_1 50\nGLEP_2 55300\nGLF0_2 3e-9 1\n"
              "GLF2_2 1e-27 1\nGLEP_3 55700\nGLPH_3 -0.05 1\n",
    "Wave": "WAVE_OM 0.01\nWAVEEPOCH 55000\nWAVE1 1e-5 -2e-5\n"
            "WAVE2 3e-6 1e-6\nWAVE3 -1e-6 2e-6\n",
    "WaveX": "WXEPOCH 55000\nWXFREQ_0001 0.0015\nWXSIN_0001 1e-6 1\n"
             "WXCOS_0001 -2e-6 1\nWXFREQ_0002 0.003\nWXSIN_0002 5e-7 1\n"
             "WXCOS_0002 1e-7 1\nWXFREQ_0003 0.0045\nWXSIN_0003 2e-7 1\n"
             "WXCOS_0003 -3e-7\n",
    "DMWaveX": "DMWXEPOCH 55000\nDMWXFREQ_0001 0.0015\nDMWXSIN_0001 1e-4 1"
               "\nDMWXCOS_0001 -2e-4 1\nDMWXFREQ_0002 0.003\n"
               "DMWXSIN_0002 5e-5 1\nDMWXCOS_0002 1e-5 1\n"
               "DMWXFREQ_0003 0.0045\nDMWXSIN_0003 2e-5 1\n"
               "DMWXCOS_0003 -3e-5 1\n",
    "SolarWindDispersion": "NE_SW 8.0 1\n",
    "TroposphereDelay": "CORRECT_TROPOSPHERE Y\n",
    "ChromaticCM": "CM 0.02 1\nCM1 1e-10 1\nCM2 1e-18\nCMEPOCH 55000\n"
                   "TNCHROMIDX 4.4\n",
    "ChromaticCMX": "CMX_0001 1e-3 1\nCMXR1_0001 54100\nCMXR2_0001 54700\n"
                    "CMX_0002 -2e-3 1\nCMXR1_0002 54700\nCMXR2_0002 55300\n"
                    "CMX_0003 5e-4 1\nCMXR1_0003 55300\nCMXR2_0003 55900\n",
    "CMWaveX": "CMWXEPOCH 55000\nCMWXFREQ_0001 0.002\nCMWXSIN_0001 1e-4 1\n"
               "CMWXCOS_0001 5e-5 1\nCMWXFREQ_0002 0.004\n"
               "CMWXSIN_0002 -3e-5 1\nCMWXCOS_0002 2e-5 1\n",
    "IFunc": "SIFUNC 2\nIFUNC1 54000 1e-5\nIFUNC2 54800 -2e-5\n"
             "IFUNC3 55600 3e-5\nIFUNC4 56200 0.5e-5\n",
    "PiecewiseSpindown": "PWEP_1 54650\nPWSTART_1 54550\nPWSTOP_1 54750\n"
                         "PWPH_1 0.02 1\nPWF0_1 2e-8 1\nPWF1_1 1e-17 1\n"
                         "PWEP_2 55400\nPWSTART_2 55300\nPWSTOP_2 55500\n"
                         "PWF0_2 -1e-8 1\nPWF2_2 1e-27 1\n",
    "SolarWindDispersionX": "SWXDM_0001 1e-4 1\nSWXR1_0001 54100\n"
                            "SWXR2_0001 54500\nSWXDM_0002 2e-4 1\n"
                            "SWXR1_0002 54500\nSWXR2_0002 55000\n",
    "PLChromNoise": "TNCHROMAMP -14\nTNCHROMGAM 3\nTNCHROMC 8\n",
    "PLSWNoise": "TNSWAMP -5\nTNSWGAM 2\nTNSWC 6\n",
}
NOISE = ("PLChromNoise", "PLSWNoise")


def zoo_toas(ntoa=NTOA, seed=7):
    """(reference TOAs, port TOAs with the same host columns): ``ntoa``
    TOAs over MJD 54100-55900 at gbt (820/1400 MHz) and arecibo
    (430/1400/2300 MHz)."""
    rng = np.random.default_rng(seed)
    mjds = np.sort(rng.uniform(54100.0, 55900.0, ntoa))
    obs = ["gbt" if i % 2 else "arecibo" for i in range(ntoa)]
    freqs = np.where(np.arange(ntoa) % 2 == 1,
                     np.tile([820.0, 1400.0], ntoa)[:ntoa],
                     np.tile([430.0, 1400.0, 2300.0], ntoa)[:ntoa])
    rt = _quiet(r_get_TOAs_array, mjds, obs=obs, freqs=freqs, errors=1.0)
    return rt, toas_from_columns(rt, CPU)


_TOAS: dict = {}


def _toas():
    if not _TOAS:
        _TOAS["t"] = zoo_toas()
    return _TOAS["t"]


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo(request):
    """(component, reference model, port model, reference TOAs, port
    TOAs) of BASE plus the component's lines."""
    par = BASE + ZOO[request.param]
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    return (request.param, rm, tm) + _toas()


def test_components_and_packed_params(zoo):
    """The component lands, with the reference's component set,
    parameters (values, frozen flags, units) and packed vector."""
    name, rm, tm, _, _ = zoo
    assert name in tm.components
    _assert_models_equal(rm, tm)
    assert tm.free_params == rm.free_params


def test_parfile_round_trip(zoo):
    """as_parfile is the reference's text, and both packages build the
    same model from it again (WAVE2 and IFUNC2 stay pairs)."""
    _, rm, tm, _, _ = zoo
    text = tm.as_parfile()
    assert text == rm.as_parfile()
    again = _quiet(get_model, io.StringIO(text), device=CPU)
    r_again = _quiet(r_get_model, io.StringIO(text))
    _assert_models_equal(r_again, again)
    assert again.as_parfile() == r_again.as_parfile()


def test_delay_and_phase(zoo):
    """The total delay within 1e-12 s, the phase with equal pulse
    numbers and fractions within 1e-12 turns."""
    _, rm, tm, rt, tt = zoo
    with jax.disable_jit():
        rd = np.asarray(rm.delay(rt))
        rph = rm.phase(rt)
    td, tph = tm.delay(tt).numpy(), tm.phase(tt)
    assert np.max(np.abs(rd - td)) <= DELAY_S
    assert np.array_equal(np.asarray(rph.int), tph.int.numpy())
    assert np.max(np.abs(np.asarray(rph.frac) - tph.frac.numpy())) \
        <= PHASE_TURNS


def test_noise_bases(zoo):
    """The stacked noise basis, its weights and its wideband DM block:
    within 1e-15 of their largest entry (PLSWNoise's DM rows couple
    into the wideband DM channel, PLChromNoise's do not)."""
    name, rm, tm, rt, tt = zoo
    rp = rm.noise_model_basis_weight_pairs(rt)
    tp = tm.noise_model_basis_weight_pairs(tt)
    assert [n for n, _, _ in tp] == [n for n, _, _ in rp]
    assert bool(tp) == (name in NOISE)
    for (_, Fr, phr), (_, Ft, pht) in zip(rp, tp):
        Fr, phr = np.asarray(Fr), np.asarray(phr)
        assert Ft.shape == Fr.shape
        assert np.max(np.abs(Ft - Fr)) <= NOISE_REL * np.max(np.abs(Fr))
        assert np.max(np.abs(pht - phr)) <= NOISE_REL * np.max(phr)
    if tp:
        Dr = np.asarray(rm.noise_model_dm_designmatrix(rt))
        Dt = tm.noise_model_dm_designmatrix(tt)
        assert np.max(np.abs(Dt - Dr)) <= NOISE_REL * max(
            np.max(np.abs(Dr)), 1e-300)
        assert np.any(Dt) == (name == "PLSWNoise")


# ------------------------------------------------------------- routing


def test_later_family_members_keep_the_first_members_class():
    """WAVE2.. and IFUNC2.. are pairs, GLF0_2 and WXFREQ_0002 land on
    their families: the builder clones the first member's class, as the
    reference's step 4 does (a float in their place would misread the
    second number of the line)."""
    from pint_tpu_torch.models.parameter import pairParameter

    par = BASE + ZOO["Wave"] + ZOO["IFunc"] + ZOO["Glitch"] + ZOO["WaveX"]
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    rm = _quiet(r_get_model, io.StringIO(par))
    _assert_models_equal(rm, tm)
    wave, ifunc = tm.components["Wave"], tm.components["IFunc"]
    assert all(isinstance(wave.params[f"WAVE{k}"], pairParameter)
               for k in (1, 2, 3))
    assert wave.WAVE2.value == (3e-6, 1e-6)
    assert ifunc.IFUNC3.value == (55600.0, 3e-5)
    assert tm.components["Glitch"].glitch_ids == [1, 2, 3]
    assert [s for _, s in tm.components["WaveX"].wavex_ids] == \
        ["0001", "0002", "0003"]


def test_free_chromatic_index_with_a_sharer_refuses():
    """A free TNCHROMIDX with CMX (which reads it as a host number)
    raises the reference's ValueError; ChromaticCM alone fits it."""
    par = BASE + ZOO["ChromaticCM"].replace("TNCHROMIDX 4.4",
                                            "TNCHROMIDX 4.4 1")
    rt, tt = _toas()
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    assert "TNCHROMIDX" in tm.free_params
    assert np.all(np.isfinite(tm.designmatrix(tt)[0].numpy()))
    for extra in (ZOO["ChromaticCMX"], ZOO["CMWaveX"], ZOO["PLChromNoise"]):
        rm = _quiet(r_get_model, io.StringIO(par + extra))
        tm = _quiet(get_model, io.StringIO(par + extra), device=CPU)
        with pytest.raises(ValueError, match="TNCHROMIDX") as r_err:
            if "PLChromNoise" in rm.components:
                rm.noise_model_basis_weight_pairs(rt)
            else:
                rm.delay(rt)
        with pytest.raises(ValueError, match="TNCHROMIDX") as t_err:
            if "PLChromNoise" in tm.components:
                tm.noise_model_basis_weight_pairs(tt)
            else:
                tm.delay(tt)
        assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("line", ["WXEPOCH 55000 1", "SWM 0 1"])
def test_free_host_read_parameter_refuses(line):
    """A free parameter that device code reads as a host number (an
    epoch, the SWM switch) raises ValueError in both packages."""
    key = line.split()[0]
    extra = ZOO["WaveX"] if key == "WXEPOCH" else ZOO["SolarWindDispersion"]
    par = BASE + extra.replace(f"{key} 55000\n", "") + line + "\n"
    rt, tt = _toas()
    rm = _quiet(r_get_model, io.StringIO(par))
    tm = _quiet(get_model, io.StringIO(par), device=CPU)
    with pytest.raises(ValueError, match=key):
        rm.delay(rt)
    with pytest.raises(ValueError, match=key):
        tm.delay(tt)
