"""The photon likelihood's hand kernel (pint_tpu_torch/ops/photon_lnlike.py,
csrc/photon_lnlike.cu) on the CPU, on the NICER J0030+0451 configuration's
photons (the benchmark's inputs, made from a seed at a CPU size): the plain
version of the kernel's algorithm against ``PhotonMCMCFitter``'s vmapped
path and against the JAX package's ``PhotonMCMCFitter`` on the same TOAs,
par file and template, its spin phase against ``dd_taylor_horner``, the
route the fitter
takes, the ``fused_batches`` counter and the benchmark's reader of it, the
wrapper's checks, and the binding against the kernel source. The kernel
runs only on a card (tests/test_torch_photon_lnlike_card.py holds it
against the plain version there)."""

import copy
import ctypes
import io
import re
import warnings

import numpy as np
import pytest
import torch

from pint_tpu.mcmc_fitter import PhotonMCMCFitter as RPhoton
from pint_tpu.models import get_model as r_get_model
from pint_tpu.templates import LCGaussian as RGaussian
from pint_tpu.templates import LCTemplate as RTemplate
from pint_tpu.toa import get_TOAs_array as r_toas_array

import pint_tpu_torch.mcmc_fitter as mcmc_fitter
from pint_tpu_torch.mcmc_fitter import PhotonMCMCFitter, fused_inputs
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.ops import cuda_build
from pint_tpu_torch.ops import photon_lnlike as pl
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.ops.taylor import dd_taylor_horner
from pint_tpu_torch.sampling import DeviceEnsembleSampler
from pint_tpu_torch.templates import SQRT_2PI, LCGaussian, LCGaussian2, \
    LCTemplate
from pint_tpu_torch.toa import TOAs

from portbench import registry

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4099
CFG = registry.config("nicer-j0030-photon")
REF = registry.module("reference", "nicer-j0030-photon")
SYS = registry.module("systems", "photon_chain")
# the plain version forms each Gaussian's images and constants in
# another order than LCGaussian.pdf: the log L of ~1e3 photons agree to
# ~1e-15 relative, and to the JAX package's (a float64 phase with an
# exact F0 product) to 2.4e-15 to 6.9e-14
REL = 1e-11
# four Gaussians: the configuration's three, and a narrow fourth
NORMS, LOCS, WIDTHS = [0.14, 0.11, 0.03, 0.06], [0.2, 0.65, 0.42, 0.93], \
    [0.055, 0.07, 0.12, 0.02]
# par lines each spin model sets or adds to the configuration's: the free
# spin terms, a phase component that reads F0 (TEMPO's WAVE: phase
# -F0 w(t)); and a TZR row
WAVE = ["WAVE_OM 0.05", "WAVEEPOCH 58205", "WAVE1 0.0004 -0.0007"]
SPIN = {"F0": ["F1 -4.3e-16"], "F0-F1": [], "F0-F2": ["F2 1e-27 1"],
        "F1, WAVE": ["F0 205.53069927"] + WAVE, "F0-F1, WAVE": WAVE}
TZR = ["TZRMJD 58210.4321", "TZRSITE @", "TZRFRQ 1400"]
SCALE = {"F0": 2e-9, "F1": 2e-17, "F2": 1e-26}


def template(k, prim=LCGaussian):
    return LCTemplate([prim() for _ in range(k)], norms=NORMS[:k],
                      locs=LOCS[:k],
                      widths=[[w] * prim.n_shape for w in WIDTHS[:k]],
                      device=CPU)


_problems: dict = {}


def _cols(photons):
    if photons not in _problems:
        a = copy.deepcopy(CFG["assumed"])
        a["photons"] = photons
        _problems[photons] = REF.simulate(dict(CFG, assumed=a), SEED, CPU)
    return _problems[photons]


def par(spin="F0-F1", tzr=False):
    """The configuration's par file with the spin model's and the TZR
    row's lines."""
    lines = {line.split()[0]: line for line in CFG["par"]}
    lines.update((line.split()[0], line)
                 for line in SPIN[spin] + (TZR if tzr else []))
    return "\n".join(lines.values()) + "\n"


def problem(photons, spin="F0-F1", tzr=False):
    """(TOAs, a new model): the configuration's photons at ``photons``,
    and ``par``'s model."""
    return TOAs.from_npz(SYS._npz(_cols(photons)), device=CPU), get_model(
        io.StringIO(par(spin, tzr)), device=CPU)


def walkers(fitter, n, seed=5):
    rng = np.random.default_rng(seed)
    scale = np.array([SCALE[p] for p in fitter.param_labels])
    return fitter.theta0[None, :] + 3.0 * scale[None, :] \
        * rng.standard_normal((n, fitter.nparams))


def tl_of(fitter, th):
    return torch.as_tensor(fitter._tl0[None, :]
                           + (th - fitter.theta0[None, :]))


# walkers, photons (none a multiple of the block's 512), free spin terms,
# Gaussians, weighted, TZR row
CASES = [(1, 700, "F0", 1, False, False),
         (2, 1500, "F0-F2", 2, True, True),
         (16, 1500, "F0-F1", 3, False, False),
         (16, 700, "F0-F2", 4, True, False),
         (2, 700, "F0-F1", 3, True, True),
         (1, 1500, "F0-F1", 4, False, True),
         (16, 700, "F0", 2, True, True),
         (2, 700, "F1, WAVE", 3, False, True)]


@pytest.mark.parametrize("nw,photons,spin,k,weighted,tzr", CASES)
def test_plain_matches_the_vmapped_path(nw, photons, spin, k, weighted, tzr):
    toas, model = problem(photons, spin, tzr)
    assert photons % (pl.THREADS * pl.PHOTONS)
    w = np.random.default_rng(8).uniform(0.1, 1.0, photons) \
        if weighted else None
    f = PhotonMCMCFitter(toas, model, template(k), weights=w)
    assert not f.fused                       # the CPU keeps the vmapped path
    ins = fused_inputs(model, toas, template(k), w)
    assert ins is not None
    assert (ins.spin.tzr is not None) == tzr
    assert (ins.photons.weights is not None) == weighted
    assert (ins.photons.other_hi is not None) == (spin == "F1, WAVE")
    th = walkers(f, nw)
    want = f.lnpost_batch(torch.as_tensor(th)).numpy()
    got = pl.photon_lnlike(ins, tl_of(f, th)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert nw == 1 or np.ptp(want) > 0.1     # the walkers are told apart


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


# free spin terms, Gaussians, weighted, TZR row: the TZR, weighted and
# WAVE inputs of fused_inputs each against the JAX package
JAX_CASES = [("F0-F1", 3, True, True), ("F1, WAVE", 3, False, True),
             ("F0-F2", 2, True, False), ("F0", 1, False, True)]


@pytest.mark.parametrize("spin,k,weighted,tzr", JAX_CASES)
def test_plain_matches_the_jax_package(spin, k, weighted, tzr):
    """The plain version on ``fused_inputs``' columns against the JAX
    package's PhotonMCMCFitter on the same TOAs (the reference's
    barycentred TOAs, carried into the port by ``toas_from_columns``),
    par file and template, at 16 walkers."""
    cols = _cols(1500)
    rt = _quiet(r_toas_array, (cols["mjd_day"], (cols["mjd_frac_hi"],
                                                 cols["mjd_frac_lo"])),
                obs="barycenter", freqs=np.inf, errors=1.0)
    w = np.random.default_rng(8).uniform(0.1, 1.0, rt.ntoas) \
        if weighted else None
    rf = _quiet(RPhoton, rt, _quiet(r_get_model, io.StringIO(par(spin, tzr))),
                RTemplate([RGaussian() for _ in range(k)], NORMS[:k],
                          LOCS[:k], WIDTHS[:k]),
                weights=w, nwalkers=16, mode="host")
    toas = toas_from_columns(rt, CPU)
    model = get_model(io.StringIO(par(spin, tzr)), device=CPU)
    f = PhotonMCMCFitter(toas, model, template(k), weights=w, mode="host")
    np.testing.assert_array_equal(f.theta0, rf.theta0)
    ins = fused_inputs(model, toas, template(k), w)
    assert (ins.spin.tzr is not None) == tzr
    assert (ins.photons.other_hi is not None) == (spin == "F1, WAVE")
    th = walkers(f, 16)
    want = rf._photon_lnlike_batch(th)
    got = pl.photon_lnlike(ins, tl_of(f, th)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert np.ptp(want) > 1.0                # the walkers are told apart


@pytest.mark.parametrize("nterms", [1, 2, 3, 5])
def test_spin_phase_is_dd_taylor_horner(nterms):
    """The plain version's Horner over F_j / (j + 1)! is Spindown's
    dd_taylor_horner bit for bit, walker by walker."""
    rng = np.random.default_rng(nterms)
    dt = DD(torch.as_tensor(rng.uniform(-2e7, 2e7, 64)),
            torch.as_tensor(rng.uniform(-1e-10, 1e-10, 64)))
    hi = [205.53069927, -4.3e-16, 1.1e-27, -3e-35, 7e-43][:nterms]
    lows = rng.uniform(-1e-14, 1e-14, (3, nterms)) * np.abs(hi)
    spin = pl.Spin(hi, [0.0] * nterms, list(range(nterms)))
    got = pl._spin_phase(pl._coefficients(torch.as_tensor(lows), spin),
                         DD(dt.hi[None, :], dt.lo[None, :]))
    z = torch.zeros_like(dt.hi)
    for w in range(3):
        want = dd_taylor_horner(dt, [DD(z, z)] + [
            DD(torch.tensor(h, dtype=torch.float64),
               torch.tensor(lo, dtype=torch.float64))
            for h, lo in zip(hi, lows[w])])
        assert torch.equal(got.hi[w], want.hi)
        assert torch.equal(got.lo[w], want.lo)


@pytest.mark.parametrize("width", [0.001, 0.02, 0.3, 2.0])
def test_images_are_the_seven_exps(width):
    """Three exps and products give the seven images' sum to ~1e-15
    relative, with no overflow for a narrow Gaussian, and 0 where every
    image underflows."""
    d = torch.linspace(-1.49, 1.49, 2001, dtype=torch.float64)
    c = -0.5 / (width * width)
    want = sum(torch.exp(c * (d + n) ** 2) for n in range(-3, 4))
    got = pl._images(d, c)
    assert torch.isfinite(got).all()
    assert torch.all(torch.abs(got - want) <= 1e-14 * want + 1e-300)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_template_constants_are_rounded_once(k):
    """``gaussians`` forms LCTemplate._pdf_fn's constants from the
    template's parameters, each within an ulp or two of the float64
    steps, and the density from them is the template's. The
    configuration's background reads 0.72, the correctly rounded softmax,
    where the float64 softmax reads 0.7199999999999999."""
    t = template(k)
    g = pl.gaussians(t.theta, k)
    theta = torch.as_tensor(np.asarray(t.theta, dtype=np.float64))
    p = torch.softmax(theta[:k + 1], dim=0)
    w = torch.exp(theta[2 * k + 1:])
    np.testing.assert_allclose(g.bg, float(p[0]), rtol=4e-16, atol=0)
    np.testing.assert_allclose(g.amp, (p[1:] / (w * SQRT_2PI)).numpy(),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(g.c, (-0.5 / (w * w)).numpy(), rtol=1e-15,
                               atol=0)
    assert g.loc == theta[k + 1:2 * k + 1].tolist()
    x = torch.linspace(0.0, 1.0, 1001, dtype=torch.float64)
    dens = g.bg + sum(a * pl._images(x - loc, c)
                      for a, loc, c in zip(g.amp, g.loc, g.c))
    np.testing.assert_allclose(dens.numpy(), t(x), rtol=1e-14, atol=0)
    if k == 3:
        assert g.bg == 0.72 and float(p[0]) == 0.7199999999999999


def _route(change):
    toas, model = problem(700)
    tmpl = template(3)
    if change == "free RAJ":
        model.RAJ.frozen = False
    elif change == "free PEPOCH":
        model.PEPOCH.frozen = False
    elif change == "LCGaussian2":
        tmpl = template(3, LCGaussian2)
    elif change == "location 1.6":
        tmpl = LCTemplate([LCGaussian()], norms=[0.2], locs=[1.6],
                          widths=[0.05], device=CPU)
    elif change == "WAVE with F0 free":
        toas, model = problem(700, "F0-F1, WAVE")
    model.invalidate_cache()
    return toas, model, tmpl


@pytest.mark.parametrize("change", [
    "free RAJ", "free PEPOCH", "LCGaussian2", "location 1.6",
    "WAVE with F0 free"])
def test_the_route_keeps_the_vmapped_path_beyond_the_kernel(change,
                                                            monkeypatch):
    """What the kernel cannot evaluate keeps the vmapped path, on any
    device: a free parameter that is no spin term, a template primitive
    that is no LCGaussian or lies outside (-1/2, 3/2), a phase component
    that moves with a free term."""
    toas, model, tmpl = _route(change)
    assert fused_inputs(model, toas, tmpl) is None
    monkeypatch.setattr(mcmc_fitter, "kernel_route", fused_inputs)
    assert not PhotonMCMCFitter(toas, model, tmpl).fused


@pytest.mark.parametrize("route", ["vmapped", "kernel"])
def test_fused_batches_count_only_kernel_batches(route, monkeypatch):
    """A short chain: ``fused_batches`` counts the batches the kernel's
    route evaluated (taken here on the CPU, where the wrapper runs the
    plain version), none on the vmapped path; the two routes' chains
    agree."""
    toas, model = problem(700)
    vm = PhotonMCMCFitter(toas, model, template(3))
    assert not vm.fused                      # the CPU keeps the vmapped path
    if route == "kernel":
        monkeypatch.setattr(mcmc_fitter, "kernel_route", fused_inputs)
    f = PhotonMCMCFitter(toas, model, template(3), nwalkers=8)
    assert f.fused == (route == "kernel")
    sampler = DeviceEnsembleSampler(8, 2, f.lnpost_batch, device=CPU)
    sampler.run_mcmc(walkers(f, 8, seed=3), 3, seed=9, mode="scan")
    c = f.metrics.snapshot()
    assert c["walker_evals"] == 8 + 3 * 8
    assert c["lnlike_batches"] == 1 + 3 * 2
    assert c["fused_batches"] == (c["lnlike_batches"] if f.fused else 0)
    read = registry.module("layer_metrics", "fused_share.photon").read
    assert read({"counters": c}) == (1.0 if f.fused else 0.0)
    th = walkers(f, 5, seed=4)
    np.testing.assert_allclose(
        f.lnpost_batch(torch.as_tensor(th)).numpy(),
        vm.lnpost_batch(torch.as_tensor(th)).numpy(), rtol=REL, atol=0)


def test_the_share_reads_nothing_without_batches():
    read = registry.module("layer_metrics", "fused_share.photon").read
    assert read({"counters": {}}) is None
    assert read({"counters": {"walker_evals": 32, "lnlike_batches": 2}}) \
        == 0.0                                 # a program that counts none


def _inputs(n=600, W=2):
    ph = pl.Photons(torch.zeros(n, dtype=torch.float64),
                    torch.zeros(n, dtype=torch.float64))
    spin = pl.Spin([205.5, -4e-16], [0.0, 0.0], [0, 1])
    gauss = pl.Gaussians(0.7, [1.0], [0.3], [-100.0])
    return ph, torch.zeros((W, 2), dtype=torch.float64), spin, gauss


def _bad(what):
    ph, tl, spin, gauss = _inputs()
    if what == "float32":
        tl = tl.float()
    elif what == "numpy":
        tl = tl.numpy()
    elif what == "not contiguous":
        tl = torch.zeros((2, 4), dtype=torch.float64)[:, ::2]
    elif what == "1-D tl":
        tl = tl[0]
    elif what == "no walkers":
        tl = tl[:0]
    elif what == "too many walkers":
        tl = torch.zeros((pl.MAX_WALKERS + 1, 2), dtype=torch.float64)
    elif what == "meta device":
        tl = tl.to("meta")
    elif what == "columns of two lengths":
        ph = ph._replace(dt_lo=torch.zeros(599, dtype=torch.float64))
    elif what == "other without its low word":
        ph = ph._replace(other_hi=ph.dt_hi)
    elif what == "column past tl":
        spin = spin._replace(col=[0, 2])
    elif what == "too many terms":
        n = pl.MAX_TERMS + 1
        spin = pl.Spin([1.0] * n, [0.0] * n, [-1] * n)
    elif what == "location 1.5":
        gauss = gauss._replace(loc=[1.5])
    return ph, tl, spin, gauss


@pytest.mark.parametrize("what,err", [
    ("float32", TypeError), ("numpy", TypeError),
    ("not contiguous", ValueError), ("1-D tl", ValueError),
    ("no walkers", ValueError), ("too many walkers", ValueError),
    ("meta device", ValueError), ("columns of two lengths", ValueError),
    ("other without its low word", ValueError),
    ("column past tl", ValueError), ("too many terms", ValueError),
    ("location 1.5", ValueError)])
def test_wrapper_refuses(what, err):
    ph, tl, spin, gauss = _bad(what)
    with pytest.raises(err):
        pl.photon_lnlike(pl.Inputs(ph, spin, gauss), tl)


def test_nblocks():
    tile = pl.THREADS * pl.PHOTONS
    assert [pl.nblocks(n) for n in (0, 1, tile, tile + 1, 2 ** 20)] == \
        [1, 1, 1, 2, 2 ** 20 // tile]


_C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
            "int": ctypes.c_int, "const double*": pl._PD,
            "const int*": pl._PI}


def test_binding_matches_the_c_signature():
    src = pl._SRC.read_text()
    sig = re.search(r'extern "C" int photon_lnlike_launch\(([^)]*)\)',
                    src).group(1)
    params = [re.sub(r"\s*\w+$", "", p.strip()) for p in sig.split(",")]
    assert [_C_TYPES[p] for p in params] == pl._LAUNCH_ARGTYPES


def test_kernel_source_and_build_are_lazy():
    src = pl._SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kThreads"), const("kPhotons"), const("kMaxWalkers"),
            const("kMaxTerms"), const("kMaxPeaks"), const("kImages")) == \
        (pl.THREADS, pl.PHOTONS, pl.MAX_WALKERS, pl.MAX_TERMS, pl.MAX_PEAKS,
         pl.IMAGES)
    assert "replaces no Pallas kernel" in src
    assert not re.search(r"atomic\w*\(", src)   # a deterministic sum
    assert "__fma_rn(a, b, -p)" in src         # the exact product error
    # every launch is followed by its error check
    code = re.sub(r"//[^\n]*", "", src)
    assert code.count("<<<") == code.count("cudaGetLastError()") == 2
    assert "arch=compute_90a,code=sm_90a" in pl._NVCC_FLAGS
    assert pl._lib is None                     # importing built nothing


def test_parse_ptxas():
    name = ("_ZN49_GLOBAL__N__05d302fc_16_photon_lnlike_cu_b488239013lnlike_"
            "kernelILb1ELb0EEEvPKdS2_S2_S2_S2_iS2_iNS_4SpinENS_5GaussEPd")
    text = (f"ptxas info    : Compiling entry function '{name}' for "
            "'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used 74 registers, used 1 barriers\n")
    assert cuda_build.parse_ptxas(text) == {name: {
        "spill_stores": 0, "spill_loads": 0, "regs": 74}}
