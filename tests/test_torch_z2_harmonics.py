"""The Z^2_m harmonics module of the port (pint_tpu_torch.ops.z2_harmonics)
on the CPU: its plain version against the Pallas kernel in interpret mode
and against pint_tpu.eventstats._z2_sums, and the wrapper's CPU routing
and argument checks. The CUDA kernel itself runs only on a GPU
(chip_smoke.py holds it against this plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.eventstats import _z2_sums
from pint_tpu.ops.pallas_kernels import z2_harmonics_pallas

from pint_tpu_torch.ops import z2_harmonics as zmod


def _inputs(n, seed=1, wlo=0.1):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=n), rng.uniform(wlo, 1.0, size=n)


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


def test_kernel_source_and_build_are_lazy():
    src = zmod._SRC.read_text()
    assert "extern \"C\" int z2_harmonics_launch" in src
    assert "pallas_kernels.py" in src   # names the TPU kernel it replaces
    assert "-gencode" in zmod._NVCC_FLAGS and \
        "arch=compute_90a,code=sm_90a" in zmod._NVCC_FLAGS
