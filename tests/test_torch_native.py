"""The port's native MJD parser (pint_tpu_torch/native, source
pint_tpu_torch/csrc/mjdparse.cpp) against the Python parser and the
reference's native parser on the CPU (oracle: tests/test_native.py):
bit-identical results, the same refusals, the >= 256-string route of
time.mjd.parse_mjd_strings, the build keyed on the source, and the
warned fallback to Python when g++ fails."""

import os
import shutil

import numpy as np
import pytest

import pint_tpu_torch.native as native
from pint_tpu.native import mjdparse_native as r_native
from pint_tpu.native import native_available as r_available
from pint_tpu_torch.time import mjd as tmjd

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ toolchain")


def _random_mjd_strings(n, rng):
    days = rng.integers(40000, 60000, n)
    out = []
    for d in days:
        nd = int(rng.integers(0, 25))
        frac = "".join(rng.choice(list("0123456789"), nd)) if nd else ""
        out.append(f"{d}.{frac}" if frac else str(d))
    return out + ["-1234.5", "58000.000000000000000001", "0.5", "58000",
                  "  55000.25\t"]


def _python(strs):
    return tmjd.parse_mjd_strings(strs, use_native=False)


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][0], b[1][0])
    np.testing.assert_array_equal(a[1][1], b[1][1])


@needs_gxx
def test_native_is_bitwise_the_python_and_reference_parsers():
    strs = _random_mjd_strings(3000, np.random.default_rng(0))
    assert native.native_available()
    got = native.mjdparse_native(strs)
    _same(got, _python(strs))
    if r_available():
        _same(got, r_native(strs))


@needs_gxx
@pytest.mark.parametrize("bad", [["58000.5", "not_a_number"],
                                 ["58000.5e3"], ["58000.5\x00"]])
def test_native_refuses_what_python_refuses(bad):
    with pytest.raises(ValueError):
        native.mjdparse_native(bad)
    with pytest.raises(ValueError):
        _python(bad)


@needs_gxx
def test_parse_mjd_strings_routes_large_batches_natively(monkeypatch):
    """From 256 strings parse_mjd_strings takes the native parser (and
    equals the Python parse bitwise); below that it does not."""
    calls, parse = [], native.mjdparse_native

    def counted(strs):
        calls.append(len(strs))
        return parse(strs)

    monkeypatch.setattr(native, "mjdparse_native", counted)
    rng = np.random.default_rng(1)
    strs = [f"{d}.{f:016d}" for d, f in zip(rng.integers(50000, 60000, 300),
                                            rng.integers(0, 10 ** 16, 300))]
    _same(tmjd.parse_mjd_strings(strs), _python(strs))
    _same(tmjd.parse_mjd_strings(strs[:255]), _python(strs[:255]))
    assert calls == [300]


@needs_gxx
def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The library's name carries a hash of the source and the flags: an
    edited source builds a new library beside the old one."""
    path = native._path()
    assert path.parent == native._BUILD_DIR and path.exists()
    edited = tmp_path / "mjdparse.cpp"
    edited.write_text(native._SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "_SRC", edited)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    other = native.build()
    assert other != path and other.exists()
    assert native.build() == other   # built once


def test_failed_build_warns_and_parses_in_python(tmp_path, monkeypatch):
    """The reference's contract: when g++ fails the loader warns, the
    native parser answers None and parse_mjd_strings parses in Python."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_FLAGS", ["-fno-such-flag-at-all"])
    strs = _random_mjd_strings(300, np.random.default_rng(2))
    with pytest.warns(UserWarning, match="pure-Python"):
        assert native.mjdparse_native(strs) is None
    assert not native.native_available()
    _same(tmjd.parse_mjd_strings(strs), _python(strs))
    assert not os.listdir(tmp_path / "build")   # no half-written library
