"""The port imports nothing of jax or of the JAX package: in a fresh
interpreter where ``import jax`` and ``import pint_tpu`` fail, every
module of pint_tpu_torch imports, and the array plane runs on the CPU (a
batch solve and one GWB log-likelihood on a tiny synthetic array), and
so does the Bayesian plane (a DevicePosterior of a tiny simulated
pulsar, fixed-noise and noise-sampled) and the photon plane (a template,
an LCFitter value and a PhotonMCMCFitter likelihood batch on that
pulsar's TOAs), and so do the runtime and the obs core (a GLS fit whose
solves hang under a fault plan and fail over to the numpy mirror, the
registry's exposition, a span), and so does the host API (a UNITS TCB
par converted, polycos generated, an ecliptic round trip, a design
matrix, select, d_phase_d_toa and the native MJD parser), and so do the
health, perf and SLO planes (an armed step's health vector, a shadowed
GLS solve, a padded step, the decomposition of a guarded dispatch, the
compile ledger, a profiler window, an SLO tick, the scoreboard), and so
does the serve layer (every module of pint_tpu_torch.serve and the
pint_serve daemon import; one engine coalesces the array's fit steps and
a polyco read into two device dispatches), and so do the scripts, pintk
and the analysis plane (every script, pintk and analysis module imports,
none of them importing Tk or matplotlib; a Pulsar's plot arrays under a
Sanitizer, compare_parfiles, a T2 conversion, a G17 and a G9 finding),
and so do the precision routes (an anchored step and the anchored,
float32-Jacobian, float32-Gram step), and so does the device mesh (a
TOA-sharded step and a batch solve over a CPU pulsar mesh)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["pint_tpu"] = None
import importlib, pkgutil

import numpy as np

import pint_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    pint_tpu_torch.__path__, "pint_tpu_torch."))
for name in names:
    importlib.import_module(name)
for name in ("pint_tpu_torch.pta.gwb", "pint_tpu_torch.parallel.pta",
             "pint_tpu_torch.sampling.kernel",
             "pint_tpu_torch.sampling.serve_kernel",
             "pint_tpu_torch.bayesian", "pint_tpu_torch.sampler",
             "pint_tpu_torch.mcmc_fitter", "pint_tpu_torch.gridutils",
             "pint_tpu_torch.models.priors",
             "pint_tpu_torch.sampling.likelihood",
             "pint_tpu_torch.sampling.posterior",
             "pint_tpu_torch.sampling.chain",
             "pint_tpu_torch.templates", "pint_tpu_torch.templates.energy",
             "pint_tpu_torch.scripts.event_optimize",
             "pint_tpu_torch.scripts.fermiphase", "pint_tpu_torch.toa",
             "pint_tpu_torch.logging", "pint_tpu_torch.runtime",
             "pint_tpu_torch.runtime.breaker",
             "pint_tpu_torch.runtime.faults",
             "pint_tpu_torch.runtime.locks",
             "pint_tpu_torch.runtime.supervisor", "pint_tpu_torch.obs",
             "pint_tpu_torch.obs.tracer", "pint_tpu_torch.obs.hist",
             "pint_tpu_torch.obs.flight", "pint_tpu_torch.obs.metrics",
             "pint_tpu_torch.native", "pint_tpu_torch.polycos",
             "pint_tpu_torch.utils", "pint_tpu_torch.modelutils",
             "pint_tpu_torch.derived_quantities",
             "pint_tpu_torch.pint_matrix", "pint_tpu_torch.binaryconvert",
             "pint_tpu_torch.models.tcb_conversion",
             "pint_tpu_torch.obs.health", "pint_tpu_torch.obs.slo",
             "pint_tpu_torch.obs.perf", "pint_tpu_torch.profiling",
             "pint_tpu_torch.serve", "pint_tpu_torch.serve.request",
             "pint_tpu_torch.serve.bucket", "pint_tpu_torch.serve.append",
             "pint_tpu_torch.serve.scheduler",
             "pint_tpu_torch.serve.metrics",
             "pint_tpu_torch.serve.admission",
             "pint_tpu_torch.serve.router", "pint_tpu_torch.serve.journal",
             "pint_tpu_torch.serve.fleet", "pint_tpu_torch.serve.workload",
             "pint_tpu_torch.scripts.pint_serve",
             "pint_tpu_torch.scripts.compare_parfiles",
             "pint_tpu_torch.scripts.convert_parfile",
             "pint_tpu_torch.scripts.pintbary",
             "pint_tpu_torch.scripts.pintpublish",
             "pint_tpu_torch.scripts.t2binary2pint",
             "pint_tpu_torch.scripts.tcb2tdb", "pint_tpu_torch.scripts.zima",
             "pint_tpu_torch.pintk", "pint_tpu_torch.pintk.pulsar",
             "pint_tpu_torch.pintk.plk", "pint_tpu_torch.pintk.colormodes",
             "pint_tpu_torch.pintk.paredit", "pint_tpu_torch.pintk.timedit",
             "pint_tpu_torch.pintk.fitbox", "pint_tpu_torch.analysis",
             "pint_tpu_torch.analysis.graftlint",
             "pint_tpu_torch.analysis.concurrency",
             "pint_tpu_torch.analysis.lock_registry",
             "pint_tpu_torch.analysis.allowlist",
             "pint_tpu_torch.analysis.sanitizer",
             "pint_tpu_torch.analysis.cfg",
             "pint_tpu_torch.analysis.graftflow",
             "pint_tpu_torch.analysis.precision_registry",
             "pint_tpu_torch.pta.shard"):
    assert name in names, name
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
# the GUI modules import neither Tk nor matplotlib at module level
gui = sorted(m for m in sys.modules
             if m.split(".")[0] in ("tkinter", "_tkinter", "matplotlib"))
assert not gui, gui

from pint_tpu_torch.parallel import pta_solve, stack_problems
from pint_tpu_torch.parallel.pta import PulsarProblem
from pint_tpu_torch.pta import GWBLikelihood

rng = np.random.default_rng(0)
probs = []
for k in range(3):
    n = 12 + k
    probs.append(PulsarProblem(rng.normal(size=(n, 3)),
                               rng.normal(size=n) * 1e-6,
                               np.full(n, 1e-12), np.zeros((n, 0)),
                               np.ones(0), ["Offset", "A", "B"]))
dparams, cov, chi2, _ = pta_solve(stack_problems(probs), device="cpu")
assert dparams.shape == (3, 3) and np.all(np.isfinite(chi2))


class _T:
    def __init__(self, n, k):
        self.tdb_day = 55000.0 + 30.0 * np.arange(n) + k
        self.tdb_frac = (np.zeros(n), np.zeros(n))


for k, pr in enumerate(probs):
    pr.toas = _T(pr.M.shape[0], k)
like = GWBLikelihood(problems=probs, gamma_matrix=np.eye(3), nfreq=2,
                     device="cpu")
val = like.loglik(-14.0, 13.0 / 3.0)
assert np.isfinite(val)

from pint_tpu_torch.serve import FitStepRequest, PhasePredictRequest, \
    ServeEngine
from pint_tpu_torch.serve.workload import demo_polyco_entry

eng = ServeEngine(device="cpu")
futs = [eng.submit(FitStepRequest(problem=pr)) for pr in probs]
futs.append(eng.submit(PhasePredictRequest(demo_polyco_entry(),
                                           [55000.0, 55000.001])))
eng.flush()
served = [f.result(timeout=0) for f in futs]
np.testing.assert_allclose(np.stack([r.dparams for r in served[:3]]),
                           dparams, rtol=1e-8, atol=1e-18)
snap = eng.metrics.snapshot()
assert snap["completed"] == 4 and snap["compile_count"] == 2, snap
assert snap["router"]["device"]["dispatches"] == 2

import io
import warnings

import torch

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.priors import GaussianPrior
from pint_tpu_torch.sampling import DevicePosterior
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

PAR = ("PSR J0006+0006\nRAJ 06:00:00.0\nDECJ 20:00:00.0\nF0 220.0 1\n"
       "F1 -1.5e-15 1\nPEPOCH 55000\nDM 15.0\nTZRMJD 55000.1\n"
       "TZRSITE @\nTZRFRQ 1400\nUNITS TDB\nEFAC -be X 1.1\n"
       "ECORR -be X 0.8\nTNREDAMP -13.5\nTNREDGAM 3.0\nTNREDC 3\n")
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    model = get_model(io.StringIO(PAR), device="cpu")
    mjds = (np.linspace(54001, 55999, 8)[:, None] + [0.0, 0.01]).ravel()
    toas = make_fake_toas_fromMJDs(mjds, model, error_us=1.0,
                                   freq_mhz=1400.0, add_noise=True,
                                   rng=np.random.default_rng(1))
for f in toas.flags:
    f["be"] = "X"
model.F1.prior = GaussianPrior(-1.5e-15, 1e-17)
for noise in (False, True):
    post = DevicePosterior(model, toas, sample_noise=noise)
    p0 = post.init_walkers(2 * post.nparams + 2,
                           rng=np.random.default_rng(2), scatter=0.1)
    lp = post.lnpost_batch(torch.as_tensor(p0))
    assert lp.shape == (len(p0),) and torch.all(torch.isfinite(lp)), lp

from pint_tpu_torch.mcmc_fitter import CompositeMCMCFitter, PhotonMCMCFitter
from pint_tpu_torch.templates import LCFitter, make_template
from pint_tpu_torch.templates.energy import LCEnergyTemplate
from pint_tpu_torch.toa import load_pickle, save_pickle

tmpl = make_template([("gaussian", 0.6, 0.4, 0.05)], device="cpu")
ph = tmpl.random(64, rng=np.random.default_rng(3))
assert np.isfinite(LCFitter(tmpl, ph, device="cpu").loglikelihood())
assert LCEnergyTemplate(tmpl, device="cpu")(ph, np.ones(64)).shape == (64,)
photon = PhotonMCMCFitter(toas, model, tmpl, nwalkers=8, mode="host")
ll = photon._photon_lnlike_batch(np.repeat(photon.theta0[None], 8, 0))
assert ll.shape == (8,) and np.all(np.isfinite(ll)), ll
assert CompositeMCMCFitter.__mro__[1] is PhotonMCMCFitter
import tempfile, os
with tempfile.TemporaryDirectory() as d:
    save_pickle(toas, os.path.join(d, "t.pickle"))
    assert load_pickle(os.path.join(d, "t.pickle"), device="cpu").ntoas \
        == toas.ntoas
import os as _os

from pint_tpu_torch import obs
from pint_tpu_torch.gls import GLSFitter
from pint_tpu_torch.obs import metrics as om
from pint_tpu_torch.runtime import Fault, FaultPlan, get_supervisor

_os.environ["PINT_TPU_DISPATCH_DEADLINE_MS"] = "200"
obs.configure(enabled=True)
with FaultPlan([Fault(match="gls.solve", kind="hang", seconds=1.0)]).active():
    with obs.span("no-jax"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = GLSFitter(toas, model).fit_toas()
assert np.isfinite(chi2)
snap = get_supervisor().snapshot()
assert snap["failovers"] == 2 and snap["timeouts"] == 2, snap
assert "pint_tpu_dispatch_failovers_total" in om.render()
assert any(r["name"] == "dispatch.failover" for r in
           obs.get_tracer().records())

from pint_tpu_torch import derived_quantities, native, utils
from pint_tpu_torch.binaryconvert import convert_binary
from pint_tpu_torch.pint_matrix import DesignMatrix
from pint_tpu_torch.polycos import Polycos
from pint_tpu_torch.time.mjd import parse_mjd_strings

with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tcb = get_model(io.StringIO(PAR.replace("UNITS TDB", "UNITS TCB")),
                    device="cpu")
    pc = Polycos.generate_polycos(model, 55000.0, 55000.1, "gbt",
                                  device="cpu")
assert tcb.UNITS.value == "TDB" and len(pc.entries) == 3
assert model.as_ECL().as_ICRS().free_params == model.free_params
assert DesignMatrix.from_model(model, toas).shape[0] == toas.ntoas
assert toas.select(np.arange(toas.ntoas) % 2 == 0).ntoas == toas.ntoas // 2
assert np.isfinite(model.d_phase_d_toa(toas)).all()
assert derived_quantities.mass_funct(1.0, 1.0) > 0
assert utils.weighted_mean([1.0, 3.0], [1.0, 1.0])[0] == 2.0
strs = [f"{55000 + k}.{k:016d}" for k in range(300)]
days, _ = parse_mjd_strings(strs)
import shutil
assert days[-1] == 55299.0
assert native.native_available() == (shutil.which("g++") is not None)

import time

from pint_tpu_torch import profiling
from pint_tpu_torch.obs import health, perf, slo
from pint_tpu_torch.parallel import build_fit_step

mon = health.configure(enabled=True, shadow_rate=1)
step, args, _ = build_fit_step(model, toas, health=True)
hv = step(*args)[4]
assert hv.shape == (3,) and float(hv[0]) == 0.0
pstep, pargs, _ = build_fit_step(model, toas, pad_to=32)
assert pargs[9].shape == (32,) and torch.isfinite(pstep(*pargs)[2])
_os.environ.pop("PINT_TPU_DISPATCH_DEADLINE_MS")
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    GLSFitter(toas, model).fit_toas()
t0 = time.monotonic()
while mon._c_shadow.total() < 2 and time.monotonic() - t0 < 60:
    time.sleep(0.02)
assert mon.status()["shadow_replays"] >= 2
assert mon.status()["shadow_drift_exceeded"] == 0
with tempfile.TemporaryDirectory() as d:
    perf.configure(enabled=True, profile_dir=d, max_s=0.2)
    get_supervisor().dispatch(lambda: torch.ones(3), key="nojax.decomp",
                              guard=True)
    assert "perf" in get_supervisor().snapshot()
    assert perf.get_ledger().get("nojax.decomp") is not None
    assert perf.request_window(0.1, reason="nojax")["ok"]
    perf.get_profiler().stop_open()
    assert perf.get_profiler().status()["last"]["status"] == "closed"
wd = slo.SLOWatchdog(specs=slo.default_specs(), interval_s=1.0)
assert wd.tick(now=0.0) == []
with profiling.annotate("nojax"):
    pass
assert profiling.scoreboard.counts["nojax"] == 1
obs.reset()

from pint_tpu_torch.analysis import Sanitizer
from pint_tpu_torch.analysis import graftlint
from pint_tpu_torch.pintk import Pulsar
from pint_tpu_torch.pintk.plk import PlkState
from pint_tpu_torch.scripts.t2binary2pint import t2_to_native_parfile
from pint_tpu_torch.scripts.compare_parfiles import main as compare_main

with tempfile.TemporaryDirectory() as d:
    par, tim = os.path.join(d, "p.par"), os.path.join(d, "p.tim")
    with open(par, "w") as f:
        f.write(model.as_parfile())
    toas.write_TOA_file(tim)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Sanitizer() as san:
            psr = Pulsar(par, tim, device="cpu")
            x, y, _, data = PlkState(psr).xy()
        assert compare_main([par, par, "--device", "cpu"]) == 0
assert san.compiles("phase") == 1 and np.all(np.isfinite(y))
assert len(x) == toas.ntoas and data["resids_us"].dtype == np.float64
assert "BINARY DDK" in t2_to_native_parfile(
    "PSR T\nBINARY T2\nPB 1.0 1\nA1 1.0\nT0 55000\nECC 0.1\nOM 10\n"
    "KIN 70\nKOM 80\n")
from pint_tpu_torch.analysis import concurrency

mod = graftlint.ModuleInfo("pint_tpu_torch/serve/_f.py",
                           "import os\nx = os.environ['X']\n")
assert [(v.rule, v.line) for v in concurrency.check_g17(mod)] == \
    [("G17", 2)]
from pint_tpu_torch.analysis import graftflow

mod = graftlint.ModuleInfo("pint_tpu_torch/models/_f.py",
                           "import torch\ndef f(pv, x):\n"
                           "    return x.to(torch.float32)\n")
assert [v.rule for v in graftflow.run_flow_checks(
    [mod], registry=[], verify_probe_sites=False)[0]] == ["G9"]
for flags in (dict(anchored=True),
              dict(anchored=True, jac_f32=True, matmul_f32=True)):
    rstep, rargs, _ = build_fit_step(model, toas, **flags)
    assert np.isfinite(float(rstep(*rargs)[2]))
from pint_tpu_torch.parallel import build_sharded_fit_step
from pint_tpu_torch.pta.shard import Mesh

mesh = Mesh(np.array(["cpu"] * 4), ("toa",))
sstep, sargs, _ = build_sharded_fit_step(model, toas, mesh)
assert np.isfinite(float(sstep(*sargs)[2]))
pmesh = Mesh(np.array(["cpu"] * 2), ("pulsar",))
assert np.array_equal(pta_solve(stack_problems(probs), mesh=pmesh)[2],
                      pta_solve(stack_problems(probs), device="cpu")[2])
gui = sorted(m for m in sys.modules
             if m.split(".")[0] in ("tkinter", "_tkinter", "matplotlib"))
assert not gui, gui
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pint_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        pytest.fail(out.stdout + out.stderr)
    assert out.stdout.strip().startswith("OK")
