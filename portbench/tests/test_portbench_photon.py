"""The photon cell's comparison fails what it must: the reference in
float32 in the program's place (the control), and the timed path broken
underneath a whole run (half of each batch's log-likelihoods swapped;
F1 dropped from the phase), on the CPU at a small size and, marked
``card``, at the cell's size. Also a whole small run with JAX made
unimportable."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pint_tpu_torch.mcmc_fitter as mcmc_fitter
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.sampling import DeviceEnsembleSampler
from portbench import registry, run
from portbench.conftest import small_photon

SPEC = registry.load_spec()
NAME = "nicer-j0030-chain"
CFG = registry.config("nicer-j0030-photon")
LIMITS = CFG["limits"]
SMALL_MIX = {"nwalkers": 8, "steps": 2}
REPO = Path(__file__).resolve().parents[2]


def _run(seed, device, small=True, seconds=0.3):
    cell = registry.cell(SPEC, NAME)
    over = (small_photon(), SMALL_MIX) if small else (None, None)
    return run.run_cell(SPEC, cell, seed, seconds, False, device, *over)


def swapped(init):
    """Each batch's first half of log-likelihoods swapped with its
    second half."""
    def wrapped(self, *a, **k):
        init(self, *a, **k)
        good = self.lnpost_batch

        def bad(x):
            out = good(x)
            h = out.shape[0] // 2
            return torch.cat([out[h:2 * h], out[:h], out[2 * h:]])
        self.lnpost_batch = bad
        self.sampler = DeviceEnsembleSampler(self.nwalkers, self.nparams,
                                             bad, device=self.device)
    return wrapped


def no_f1(f_terms):
    """The spin phase without its F1 term."""
    def wrapped(self):
        return [n for n in f_terms(self) if n != "F1"]
    return wrapped


def _break(fault, monkeypatch):
    if fault == "swapped":
        monkeypatch.setattr(mcmc_fitter.PhotonMCMCFitter, "__init__",
                            swapped(mcmc_fitter.PhotonMCMCFitter.__init__))
    else:
        monkeypatch.setattr(Spindown, "f_terms", no_f1(Spindown.f_terms))


def _control(seed, device, small=True, seconds=0.3):
    over = (small_photon(), SMALL_MIX) if small else (None, None)
    r = run.execute(registry.cell(SPEC, NAME), seed, seconds, False, device,
                    *over)
    prog = r.system_mod.check(r.system, r.calls, r.ref, r.cfg, seed, device)
    ctrl = r.system_mod.control_gaps(r.system, r.calls, r.ref, r.cfg, seed,
                                     device)
    return prog, ctrl


def _exceeds(gaps):
    return [k for k, v in gaps.items() if v > LIMITS[k]]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_float32_control_fails_a_limit(seed):
    prog, ctrl = _control(seed, torch.device("cpu"))
    assert not _exceeds(prog) and _exceeds(ctrl)


@pytest.mark.parametrize("fault", ["swapped", "no_f1"])
def test_broken_photon_path_is_not_correct(fault, monkeypatch):
    assert _run(41, torch.device("cpu"))["correct"]
    _break(fault, monkeypatch)
    out = _run(41, torch.device("cpu"))
    assert out["correct"] is False
    assert out["compared"]["lnlike_gap"]["value"] > LIMITS["lnlike_gap"]


def test_a_small_run_loads_no_jax():
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'pint_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import torch\n"
        "from portbench import registry, run\n"
        "from portbench.conftest import small_photon\n"
        "spec = registry.load_spec()\n"
        f"out = run.run_cell(spec, registry.cell(spec, {NAME!r}), 5, 0.2,"
        " True, torch.device('cpu'), small_photon(),"
        f" {SMALL_MIX!r})\n"
        "assert out['correct'], out\n"
        "for n in ('jax', 'jaxlib', 'flax', 'pint_tpu'):\n"
        "    del sys.modules[n]\n"
        "print(run.loaded_forbidden())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
@pytest.mark.parametrize("seed", [107, 2 ** 33 + 21])
def test_float32_control_fails_at_the_cells_size(seed, card_device):
    prog, ctrl = _control(seed, card_device, small=False, seconds=3.0)
    print("photon control", seed, prog, ctrl)
    assert not _exceeds(prog) and _exceeds(ctrl)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["swapped", "no_f1"])
def test_broken_photon_path_at_the_cells_size(fault, card_device,
                                              monkeypatch):
    _break(fault, monkeypatch)
    out = _run(2 ** 32 + 29, card_device, small=False, seconds=3.0)
    print("photon fault", fault, out["compared"])
    assert out["correct"] is False
    assert out["compared"]["lnlike_gap"]["value"] > LIMITS["lnlike_gap"]


def _window(monkeypatch, launches=3):
    """A traced window of three kernels launched at 1, 2 and 6 ms, and a
    ring whose `photon.lnlike` span holds the first two launches and
    whose `photon.htest` span holds the third, 5 s off the trace's axis
    (matched by the caller's dispatch range)."""
    from portbench import spans
    from portbench.trace import TraceWindow

    host = [(0.0, 0.010, "dispatch/sampling.chain")] + [
        (t, t + 1e-4, "cudaLaunchKernel") for t in (0.001, 0.002, 0.006)]
    ops = [(0.003, 0.004, "k_a"), (0.004, 0.0045, "k_b"),
           (0.007, 0.009, "void z2_kernel<float, float, 20>")]
    tr = TraceWindow(ops, {}, host[:1 + launches], launches, 0.010)
    ring = [{"ph": "X", "name": n, "ts": 5e6 + t0, "dur": d, "args": {}}
            for n, t0, d in (("dispatch/sampling.chain", 0.0, 1e4),
                             ("photon.lnlike", 500.0, 2000.0),
                             ("photon.htest", 5500.0, 1000.0))]
    monkeypatch.setattr(spans, "ring", lambda: ring)
    return {"trace": tr}


def test_spans_take_the_kernels_launched_inside_them(monkeypatch):
    from portbench import photon_trace

    ctx = _window(monkeypatch)
    assert photon_trace.lnlike_busy_s(ctx) == pytest.approx(1.5e-3)
    secs, n = photon_trace.k1_launches(ctx)
    assert secs == pytest.approx(2e-3) and n == 1


def test_unpaired_launches_read_nothing(monkeypatch):
    """Where the trace's launch calls and kernels do not pair one to
    one, nothing is attributed."""
    from portbench import photon_trace

    ctx = _window(monkeypatch, launches=2)
    assert photon_trace.lnlike_busy_s(ctx) is None
    assert photon_trace.k1_launches(ctx) is None


def test_least_times_are_the_stated_counts():
    from portbench import photon_roofline as pr
    from portbench.roofline import PEAKS

    n = 2 ** 20
    assert pr.walker_photon_flops() == 31 + 4 + 3 * 45 + 3
    per_batch = (16 * n * pr.walker_photon_flops() + n * pr.PHOTON_FLOPS) \
        / PEAKS["f64_flops"]
    assert per_batch > (n * 40 + 16 * 8) / PEAKS["hbm_bytes_per_s"]
    assert pr.lnlike_least_s(n, 512, 32) == pytest.approx(32 * per_batch)
    assert pr.z2_least_s(n, 20) == pytest.approx(
        n * 16 / PEAKS["hbm_bytes_per_s"])
