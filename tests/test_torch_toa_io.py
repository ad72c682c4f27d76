"""The port's TOA persistence (pint_tpu_torch.toa: TOAs.to_npz/from_npz,
write_TOA_file, save_pickle/load_pickle, get_TOAs(usecache=)) on the CPU,
against the reference on tests/datafile/NGC6440E.tim."""

import filecmp
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import pint_tpu.toa as rtoa
import pint_tpu_torch.toa as ttoa
from pint_tpu_torch.models import get_model_and_toas

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "datafile")
TIM = os.path.join(DATA, "NGC6440E.tim")
PAR = os.path.join(DATA, "NGC6440E.par")
CPU = "cpu"


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def batch_arrays(toas):
    """{leaf: numpy} of the TOAs' batch (tdb_frac split in two)."""
    b = toas.to_batch(CPU)
    out = {k: getattr(b, k).numpy() for k in b._fields if k != "tdb_frac"}
    out["tdb_frac_hi"] = b.tdb_frac.hi.numpy()
    out["tdb_frac_lo"] = b.tdb_frac.lo.numpy()
    return out


def assert_same_table(a, b):
    """Every column, flag and setting bitwise equal; batches too."""
    for col in ("mjd_day", "freq_mhz", "error_us", "tdb_day",
                "ssb_obs_pos", "ssb_obs_vel", "obs_sun_pos"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    for col in ("mjd_frac", "tdb_frac"):
        for x, y in zip(getattr(a, col), getattr(b, col)):
            np.testing.assert_array_equal(x, y)
    assert a.obs == b.obs and a.names == b.names and a.flags == b.flags
    assert (a.clock_applied, a.ephem, a.planets) == \
        (b.clock_applied, b.ephem, b.planets)
    assert set(a.obs_planet_pos) == set(b.obs_planet_pos)
    for k in a.obs_planet_pos:
        np.testing.assert_array_equal(a.obs_planet_pos[k],
                                      b.obs_planet_pos[k])
    ba, bb = batch_arrays(a), batch_arrays(b)
    for k in ba:
        np.testing.assert_array_equal(ba[k], bb[k])


@pytest.fixture(scope="module")
def toas():
    return _quiet(ttoa.get_TOAs, TIM, planets=True, device=CPU)


def test_npz_round_trip_is_bitwise(toas, tmp_path):
    path = tmp_path / "snap.npz"
    toas.to_npz(path)
    back = ttoa.TOAs.from_npz(path, device=CPU)
    assert back.device == torch.device(CPU) and back.weights is None
    assert back.cache_key != toas.cache_key
    assert_same_table(back, toas)
    assert [p for p in os.listdir(tmp_path)] == ["snap.npz"]  # no tmp
    toas.to_npz(path, cache_key="abc")
    with pytest.raises(ValueError, match="cache key"):
        ttoa.TOAs.from_npz(path, expect_key="xyz", device=CPU)


def test_write_TOA_file_is_byte_identical_to_reference(toas, tmp_path):
    ref = _quiet(rtoa.get_TOAs, TIM, planets=True)
    ref.write_TOA_file(str(tmp_path / "ref.tim"))
    toas.write_TOA_file(str(tmp_path / "port.tim"))
    assert filecmp.cmp(tmp_path / "ref.tim", tmp_path / "port.tim",
                       shallow=False)
    # read back: the same site-clock MJDs to 1e-16 d, flags and TDBs
    back = _quiet(ttoa.get_TOAs, str(tmp_path / "port.tim"), planets=True,
                  device=CPU)
    d = (back.mjd_day - toas.mjd_day) + (back.mjd_frac[0]
                                         - toas.mjd_frac[0]) \
        + (back.mjd_frac[1] - toas.mjd_frac[1])
    assert np.max(np.abs(d)) <= 1e-16
    assert [{k: v for k, v in f.items() if k != "clkcorr"}
            for f in back.flags] == \
        [{k: v for k, v in f.items() if k != "clkcorr"} for f in toas.flags]


def test_cache_hits_on_the_second_call(toas, tmp_path, monkeypatch):
    a = _quiet(ttoa.get_TOAs, TIM, planets=True, usecache=True,
               cachedir=str(tmp_path), device=CPU)
    caches = os.listdir(tmp_path)
    assert caches == [".NGC6440E.tim.toacache.npz"]

    def no_parse(*a, **kw):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(ttoa, "parse_tim", no_parse)
    b = ttoa.get_TOAs(TIM, planets=True, usecache=True,
                      cachedir=str(tmp_path), device=CPU)
    assert_same_table(b, a)
    assert_same_table(b, toas)
    # a changed setting is a stale key: rebuilt, the file overwritten
    with pytest.raises(AssertionError, match="cache was not used"):
        ttoa.get_TOAs(TIM, planets=False, usecache=True,
                      cachedir=str(tmp_path), device=CPU)


def test_cache_never_loads_the_reference_cache(tmp_path, monkeypatch):
    """Both packages name the cache of a tim file alike; the port's key
    names the port, so a cache the JAX package wrote is rebuilt."""
    knobs = (None, False, True, True, "BIPM2021")
    port_key = ttoa._cache_key(TIM, knobs)
    _quiet(rtoa.get_TOAs, TIM, usecache=True, cachedir=str(tmp_path))
    path = tmp_path / ".NGC6440E.tim.toacache.npz"
    with np.load(path) as z:
        ref_key = str(z["cache_key"])
    assert ref_key != port_key
    parsed = []
    real = ttoa.parse_tim
    monkeypatch.setattr(ttoa, "parse_tim",
                        lambda *a, **kw: parsed.append(1) or real(*a, **kw))
    _quiet(ttoa.get_TOAs, TIM, usecache=True, cachedir=str(tmp_path),
           device=CPU)
    assert parsed == [1]
    with np.load(path) as z:
        assert str(z["cache_key"]) == port_key


def test_get_model_and_toas_passes_usecache(tmp_path):
    m, t = _quiet(get_model_and_toas, PAR, TIM, device=CPU, usecache=True,
                  cachedir=str(tmp_path))
    assert os.listdir(tmp_path) == [".NGC6440E.tim.toacache.npz"]
    assert t.device == torch.device(CPU) and t.ntoas == 62


def test_pickle_round_trip_comes_back_on_the_cpu(toas, tmp_path):
    path = str(tmp_path / "toas.pickle")
    ttoa.save_pickle(toas, path)
    back = ttoa.load_pickle(path, device=CPU)
    assert back.device == torch.device(CPU)
    assert back.cache_key != toas.cache_key
    assert_same_table(back, toas)
    raw = pickle.loads(pickle.dumps(toas))
    assert isinstance(raw.device, torch.device)
    assert_same_table(raw, toas)
    with open(path, "wb") as fh:
        pickle.dump({"not": "toas"}, fh)
    with pytest.raises(TypeError):
        ttoa.load_pickle(path, device=CPU)


def test_loaders_default_to_cuda(toas, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    path = str(tmp_path / "t.npz")
    toas.to_npz(path)
    for load in (lambda: ttoa.TOAs.from_npz(path),
                 lambda: ttoa.load_pickle(path),
                 lambda: ttoa.get_TOAs(TIM, usecache=True,
                                       cachedir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            load()
