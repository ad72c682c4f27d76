"""The photon likelihood's hand kernel (pint_tpu_torch/csrc/photon_lnlike.cu)
on the card, at the size of the nicer-j0030-photon configuration (2^20
photons, a 16-walker batch, its three-Gaussian template), weighted and
unweighted: against its plain version and against the vmapped path; two
calls bitwise; a refused launch reported; and the benchmark's faults
(tests of portbench/tests/test_portbench_photon.py) still failing the
cell's comparison with the kernel's route on. Each test skips without a
card. This file imports no JAX; run it on the card with

    python -m pytest --noconftest tests/test_torch_photon_lnlike_card.py

(tests/conftest.py imports jax). Limits, set as PERF.md §2 sets the
benchmark's, from the readings at this size (a log L is ~4.2e4 nats):
the plain version 3.6e-12 to 7.3e-12 nats away (the same steps, CUDA's
exp and log, the sums in another order), the vmapped path 1.8e-11 to
2.9e-11 (its template's constants rounded in float64 at each step, on the
card); the limits 1e-9 and 1e-8 nats sit 137x and 340x above them, and a
fault (F1 dropped, half the walkers swapped) moves log L by 10^3-10^5."""

import ctypes

import numpy as np
import pytest
import torch

import pint_tpu_torch.mcmc_fitter as mcmc_fitter
from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter, fused_inputs
from pint_tpu_torch.ops import photon_lnlike as pl
from portbench import registry, run
from portbench.tests.test_portbench_photon import _break

pytestmark = pytest.mark.card

SEED = 2 ** 32 + 12345
SPEC = registry.load_spec()
NAME = "nicer-j0030-chain"
CFG = registry.config("nicer-j0030-photon")
SYS = registry.module("systems", "photon_chain")
PLAIN_GAP = 1e-9
VMAPPED_GAP = 1e-8


@pytest.fixture(scope="module")
def system():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return SYS.build(CFG, SEED, torch.device("cuda", 0))


def _batch(system, weighted):
    """The kernel's inputs for 16 walkers scattered by 3 sigma about the
    par file's values, and their theta."""
    f = system.fitter
    dev = f.device
    w = torch.as_tensor(np.random.default_rng(8).uniform(
        0.1, 1.0, f.toas.ntoas), device=dev) if weighted else None
    ins = fused_inputs(f.model, f.toas, f.template, w)
    rng = np.random.default_rng(5)
    th = f.theta0[None, :] + 3.0 * system.sigma[None, :] \
        * rng.standard_normal((16, f.nparams))
    tl = torch.as_tensor(f._tl0[None, :] + (th - f.theta0[None, :]),
                         device=dev)
    return ins, tl, th, w


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_matches_plain_and_vmapped(system, weighted, monkeypatch):
    f = system.fitter
    assert f.fused and f.toas.ntoas == 2 ** 20
    ins, tl, th, w = _batch(system, weighted)
    n0 = pl.launches
    got = pl.photon_lnlike(ins, tl)
    torch.cuda.synchronize()
    assert pl.launches == n0 + 1
    plain = pl.photon_lnlike_plain(ins, tl)
    monkeypatch.setattr(mcmc_fitter, "kernel_route", lambda *a: None)
    vm = PhotonMCMCFitter(f.toas, f.model, f.template, weights=w)
    assert not vm.fused
    want = vm.lnpost_batch(torch.as_tensor(th, device=f.device))
    torch.cuda.synchronize()
    gaps = (float(torch.max(torch.abs(got - plain))),
            float(torch.max(torch.abs(got - want))))
    print("photon kernel gaps (plain, vmapped)", weighted, gaps)
    assert torch.isfinite(got).all() and float(torch.std(got)) > 1.0
    assert gaps[0] <= PLAIN_GAP and gaps[1] <= VMAPPED_GAP


def test_two_calls_are_bitwise(system):
    ins, tl, _, _ = _batch(system, False)
    a = pl.photon_lnlike(ins, tl)
    b = pl.photon_lnlike(ins, tl)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_a_refused_launch_is_reported(system, monkeypatch):
    """The library checks its arguments and each launch's error; the
    wrapper raises on any it returns."""
    ins, tl, _, _ = _batch(system, False)
    ph, spin, gauss = ins.photons, ins.spin, ins.gauss
    lib = pl._load()
    out = torch.empty(tl.shape[0], dtype=torch.float64, device=tl.device)
    err = lib.photon_lnlike_launch(
        ph.dt_hi.data_ptr(), ph.dt_lo.data_ptr(), 0, 0, 0, ph.dt_hi.shape[0],
        tl.data_ptr(), tl.shape[0], tl.shape[1], pl._doubles(spin.hi),
        pl._doubles(spin.lo), (ctypes.c_int * 2)(*spin.col), 2, None,
        pl._doubles([gauss.bg]), 1, out.data_ptr(), 1, out.data_ptr(), 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1                              # cudaErrorInvalidValue

    class Refusing:
        def photon_lnlike_launch(self, *args):
            return 9                         # cudaErrorInvalidConfiguration

    monkeypatch.setattr(pl, "_lib", Refusing())
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        pl.photon_lnlike(ins, tl)
    torch.cuda.synchronize()


@pytest.mark.parametrize("fault", ["swapped", "no_f1"])
def test_the_faults_fail_with_the_kernel_route_on(fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _break(fault, monkeypatch)
    out = run.run_cell(SPEC, registry.cell(SPEC, NAME), 2 ** 32 + 29, 3.0,
                       True, torch.device("cuda", 0))
    print("photon fault, kernel route", fault, out["compared"],
          out["metrics"].get("fused_share.photon"))
    assert out["metrics"]["fused_share.photon"]["value"] == 1.0
    assert out["correct"] is False
    assert out["compared"]["lnlike_gap"]["value"] > \
        CFG["limits"]["lnlike_gap"]
