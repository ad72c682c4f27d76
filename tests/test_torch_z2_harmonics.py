"""The Z^2_m harmonics module of the port (pint_tpu_torch.ops.z2_harmonics)
on the CPU: its plain version against the Pallas kernel in interpret mode
and against pint_tpu.eventstats._z2_sums; a float32 numpy emulation of
the CUDA kernel's seed-and-rotate arithmetic against both, with a per-term
error budget; the wrapper's CPU routing and argument checks; and the
binding against the kernel source. The CUDA kernel itself runs only on a
GPU (chip_smoke.py holds it against the plain version there)."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.eventstats import _z2_sums
from pint_tpu.ops.pallas_kernels import z2_harmonics_pallas

from pint_tpu_torch.ops import z2_harmonics as zmod

F32 = np.float32
CHUNK = 32  # kChunk: most harmonics one block rotates from one seed


def _inputs(n, seed=1, wlo=0.1):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=n), rng.uniform(wlo, 1.0, size=n)


def _peaked_inputs(n, seed=2):
    """A pulsed-like set: 60 % of the phases in a narrow peak at 0 (where
    cos is near 1, the hardest place to round), the rest uniform."""
    rng = np.random.default_rng(seed)
    pulsed = rng.uniform(size=n) < 0.6
    ph = np.where(pulsed, np.mod(0.01 * rng.standard_normal(n), 1.0),
                  rng.uniform(size=n))
    return ph, rng.uniform(0.1, 1.0, size=n)


def _fma32(a, b, c):
    """float32 fma: a*b of two float32 values is exact in float64, so one
    float64 add and one rounding to float32 (double rounding aside)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


def _rotation_emulation(ph, w, m):
    """float32 emulation of the kernel's arithmetic, chunked as it chunks:
    for each chunk of at most 32 harmonics, the rotation z = e^{2 pi i phi}
    and the chunk's first weighted term u = w e^{2 pi i (k0+1) phi} from
    float64 sin/cos rounded to float32 (the kernel's seed is rounded so);
    then each harmonic sums u in float32 and rotates it, u <- u z, with
    FMUL + FFMA as the kernel does."""
    ph = np.asarray(ph, dtype=F32)
    w = np.asarray(w, dtype=F32)
    turns = ph.astype(np.float64)
    c1 = np.cos(2 * np.pi * turns).astype(F32)
    s1 = np.sin(2 * np.pi * turns).astype(F32)
    out = np.zeros((2, m))
    for k0 in range(0, m, CHUNK):
        ang = 2 * np.pi * (k0 + 1) * turns   # (k0+1) phi exact in float64
        ur = w * np.cos(ang).astype(F32)
        ui = w * np.sin(ang).astype(F32)
        for k in range(k0, min(k0 + CHUNK, m)):
            out[0, k] = np.sum(ur, dtype=F32)
            out[1, k] = np.sum(ui, dtype=F32)
            ur, ui = (_fma32(ur, c1, -(ui * s1)), _fma32(ui, c1, ur * s1))
    return out


def _exact_sums(ph, w, m):
    """float64 sums on the float32-rounded inputs the kernel computes on."""
    ph = np.asarray(ph, dtype=F32).astype(np.float64)
    w = np.asarray(w, dtype=F32).astype(np.float64)
    ang = 2 * np.pi * np.arange(1, m + 1)[:, None] * ph[None, :]
    return np.stack([np.cos(ang) @ w, np.sin(ang) @ w])


@pytest.mark.parametrize("peaked", [False, True])
@pytest.mark.parametrize("m", [1, 2, 20, 32, 33, 129])
def test_rotation_emulation_error_budget(m, peaked):
    """Each term of seed-and-rotate is within 4 k 2^-24 sum|w| of the
    exact sums: the k-th term has been rotated at most min(k, 32) - 1
    times (each multiply errs ~2^-24), on a correctly rounded seed, plus
    the float32 sums."""
    ph, w = (_peaked_inputs if peaked else _inputs)(8209, seed=6)
    err = np.abs(_rotation_emulation(ph, w, m) - _exact_sums(ph, w, m))
    k = np.arange(1, m + 1)
    budget = 4 * k * 2.0 ** -24 * np.sum(np.abs(w.astype(F32)))
    assert np.all(err <= budget[None, :]), (err / budget).max()


@pytest.mark.parametrize("m", [1, 2, 20, 32, 33, 129])
def test_rotation_emulation_matches_reference(m):
    """Seed-and-rotate against the reference's float64 sums and, where
    the Pallas kernel takes m (m <= 128), its interpret mode, at the
    tests/test_pallas_kernels.py tolerances."""
    n = 8209
    ph, w = _inputs(n, seed=7)
    got = _rotation_emulation(ph, w, m)
    tol = dict(rtol=5e-4, atol=5e-3 * np.sqrt(n))
    c, s = _z2_sums(jnp.asarray(ph), jnp.asarray(w), m)
    np.testing.assert_allclose(got[0], np.asarray(c), **tol)
    np.testing.assert_allclose(got[1], np.asarray(s), **tol)
    if m <= 128:
        pc, ps = z2_harmonics_pallas(ph, w, m=m, interpret=True)
        np.testing.assert_allclose(got[0], np.asarray(pc), **tol)
        np.testing.assert_allclose(got[1], np.asarray(ps), **tol)


@pytest.mark.parametrize("n", [1000, 8192, 20000])
@pytest.mark.parametrize("m", [2, 20])
def test_plain_f32_matches_pallas_interpret(n, m):
    ph, w = _inputs(n)
    c, s = z2_harmonics_pallas(ph, w, m=m, interpret=True)
    got = zmod.z2_harmonics_plain(torch.as_tensor(ph, dtype=torch.float32),
                                  torch.as_tensor(w, dtype=torch.float32), m)
    assert got.dtype == torch.float32 and got.shape == (2, m)
    # f32 accumulation: the tests/test_pallas_kernels.py tolerances
    np.testing.assert_allclose(got[0].numpy(), np.asarray(c),
                               rtol=5e-4, atol=5e-3 * np.sqrt(n))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(s),
                               rtol=5e-4, atol=5e-3 * np.sqrt(n))


def test_plain_padding_inert_case():
    """n not a multiple of the Pallas tile: the zero-weight padding of
    the TPU kernel and the unpadded plain version must agree."""
    n = 8192 + 17
    ph, w = _inputs(n, seed=3, wlo=0.5)
    c, s = z2_harmonics_pallas(ph, w, m=3, interpret=True)
    got = zmod.z2_harmonics_plain(torch.as_tensor(ph, dtype=torch.float32),
                                  torch.as_tensor(w, dtype=torch.float32), 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(c),
                               rtol=2e-3, atol=0.05)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(s),
                               rtol=2e-3, atol=0.05)


@pytest.mark.parametrize("m", [1, 2, 20, 129])
def test_plain_f64_matches_reference_sums(m):
    ph, w = _inputs(3000, seed=4)
    c, s = _z2_sums(jnp.asarray(ph), jnp.asarray(w), m)
    got = zmod.z2_harmonics_plain(torch.as_tensor(ph), torch.as_tensor(w), m)
    assert got.dtype == torch.float64
    # the same float64 terms summed in another order
    np.testing.assert_allclose(got[0].numpy(), np.asarray(c), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(s), rtol=1e-12)


def test_wrapper_on_cpu_uses_plain_version_and_counts_no_launch():
    ph, w = _inputs(500, seed=5)
    before = zmod.launches
    got = zmod.z2_harmonics(torch.as_tensor(ph), torch.as_tensor(w), 7)
    want = zmod.z2_harmonics_plain(torch.as_tensor(ph), torch.as_tensor(w),
                                   7)
    assert torch.equal(got, want)
    assert zmod.launches == before
    assert zmod._lib is None  # nothing was built or loaded


@pytest.mark.parametrize("bad", [
    dict(m=0), dict(m=2.0), dict(m=True), dict(w_len=9),
    dict(dtype=torch.int64), dict(two_d=True)])
def test_wrapper_rejects_bad_arguments(bad):
    n = 10 if not bad.get("two_d") else (2, 5)
    dt = bad.get("dtype", torch.float64)
    ph = torch.zeros(n, dtype=dt)
    w = torch.ones(bad.get("w_len", n), dtype=dt)
    with pytest.raises((ValueError, TypeError)):
        zmod.z2_harmonics(ph, w, bad.get("m", 3))


@pytest.mark.parametrize("pdt,wdt", [
    (torch.float64, torch.float64), (torch.float32, torch.float64),
    (torch.float64, torch.float32), (torch.float32, torch.float32)])
def test_wrapper_on_cpu_routes_every_dtype_to_plain_version(pdt, wdt):
    """On the CPU, float64 and mixed inputs reach the plain version as
    they are: no cast, the plain version's dtype, no launch, no build."""
    a, b = _inputs(300, seed=8)
    ph, w = torch.as_tensor(a, dtype=pdt), torch.as_tensor(b, dtype=wdt)
    before = zmod.launches
    got = zmod.z2_harmonics(ph, w, 4)
    want = zmod.z2_harmonics_plain(ph, w, 4)
    assert torch.equal(got, want)
    assert got.dtype == want.dtype == torch.promote_types(pdt, wdt)
    assert (ph.dtype, w.dtype) == (pdt, wdt)
    assert zmod.launches == before
    assert zmod._lib is None


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "int*": ctypes.POINTER(ctypes.c_int)}


def _c_params(src, fn):
    """Parameter types of an extern "C" function in the kernel source."""
    sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src).group(1)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in sig.split(",")]


@pytest.mark.parametrize("fn,argtypes", [
    ("z2_harmonics_launch", zmod._LAUNCH_ARGTYPES),
    ("z2_harmonics_plan", zmod._PLAN_ARGTYPES)])
def test_binding_matches_the_c_signatures(fn, argtypes):
    params = _c_params(zmod._SRC.read_text(), fn)
    assert [_C_TYPES[p] for p in params] == argtypes


def test_wrapper_constants_match_the_source():
    src = zmod._SRC.read_text()

    def const(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);",
                             src).group(1))

    assert const("kThreads") == zmod._THREADS
    assert const("kPhotons") == zmod._PHOTONS_PER_STEP
    assert const("kGroup") == zmod._GROUP
    assert const("kChunk") == CHUNK


def test_parse_ptxas_reads_registers_and_spills():
    text = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19z2_kernelIdfLi20EEEvPKvS2_xiPdPjS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19z2_kernelIdfLi20EEEvPKvS2_xiPdPjS3_
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 99 registers, used 1 barriers, 352 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19z2_kernelIffLi4EEEvPKvS2_xiPdPjS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19z2_kernelIffLi4EEEvPKvS2_xiPdPjS3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers, 96 bytes smem
"""
    rep = zmod.parse_ptxas(text)
    assert rep == {("d", "f", 20): {"spill_stores": 8, "spill_loads": 12,
                                    "regs": 99},
                   ("f", "f", 4): {"spill_stores": 0, "spill_loads": 0,
                                   "regs": 60}}


def test_kernel_source_and_build_are_lazy():
    src = zmod._SRC.read_text()
    assert _c_params(src, "z2_harmonics_launch") == [
        "const void*", "int", "const void*", "int", "long long", "int",
        "void*", "int", "void*", "void*", "int", "void*"]
    assert "pallas_kernels.py" in src   # names the TPU kernel it replaces
    assert "sincospif(" not in src.split("What does not apply")[1]
    assert "atomicAdd" in src and not re.search(
        r"atomicAdd\(\s*[^,]*(float|double)", src)  # integer tickets only
    assert "-gencode" in zmod._NVCC_FLAGS and \
        "arch=compute_90a,code=sm_90a" in zmod._NVCC_FLAGS
    assert "-v" in zmod._NVCC_FLAGS   # ptxas's register and spill report
    assert zmod._lib is None          # importing built nothing
