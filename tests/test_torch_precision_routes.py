"""The opt-in precision routes of the port's fit step (anchored delta
phase, float32 Jacobian, float32 Gram) held to the same routes of
pint_tpu on the CPU, and to the port's own float64 step at the limits of
the reference's oracles (tests/test_anchored.py, tests/test_jac32.py),
with the dd32 substrate (``f64_to_dd32``, ``dd_to_dd32``,
``dd_from_parts``, dd ops on float32 pairs, ``taylor_powdiff``) bitwise
the reference's where both run IEEE eager arithmetic.

The reference runs under ``jax.disable_jit()`` (its build included: its
anchor is computed with ``jax.jit``, and XLA's compiled CPU code
contracts the dd error-free transforms into FMAs, ~1e-6 turns on a
binary); its Gram solve, which holds no dd, is compiled, as
tests/test_torch_wideband_step.py does. The port's float64 parts of a
route agree with the reference's to the step limits of test_torch_fit.py
(the two libraries' trigonometric functions round some delays one ulp
apart, ~3e-14 s); a float32 route agrees within 1e-4 sigma.

test_anchored.py::test_anchored_sharded_equals_unsharded is ported with
the sharded step, in tests/test_torch_mesh.py.
"""

import copy
import importlib
import io
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pint_tpu.models import get_model as r_get_model
from pint_tpu.ops import taylor as rtaylor
from pint_tpu.parallel import build_fit_parts as r_build_fit_parts
from pint_tpu.parallel.fit_step import _gls_core as r_gls_core
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake

from pint_tpu_torch import config
from pint_tpu_torch.gls import DeviceDownhillGLSFitter, \
    StreamingGLSFitter
from pint_tpu_torch.gridutils import grid_chisq
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.ops import taylor as ptaylor
from pint_tpu_torch.parallel import build_fit_step
from pint_tpu_torch.parallel import fit_step as pfs
from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

from test_torch_fit import chi2_tol

# the dd modules (``ops.dd`` names the package's dd() function too)
rdd = importlib.import_module("pint_tpu.ops.dd")
pdd = importlib.import_module("pint_tpu_torch.ops.dd")

CPU = "cpu"
ROUTE_ENV = ("PINT_TPU_ANCHORED", "PINT_TPU_JAC", "PINT_TPU_GLS_MATMUL",
             "PINT_TPU_HEALTH_DRIFT_SIGMA")

BASE = """PSR J0000+0000
RAJ 12:00:00.0 1
DECJ 30:00:00.0 1
F0 300.123456789 1
F1 -1.0e-15 1
DM 20.0 1
PEPOCH 55000
POSEPOCH 55000
TZRMJD 55000.1
TZRSITE @
TZRFRQ 1400
UNITS TDB
"""

# tests/test_anchored.py's cases
CASES = {
    "isolated-f2": "F2 1e-26 1\nPMRA 2.0 1\nPMDEC -3 1\nPX 1.2 1\n",
    "ecorr-red": ("EFAC -be X 1.1\nEQUAD -be X 0.3\nECORR -be X 1.2\n"
                  "TNREDAMP -13.7\nTNREDGAM 3.5\nTNREDC 10\n"),
    "ell1-short-pb": ("BINARY ELL1\nPB 0.38 1\nA1 1.42 1\n"
                      "TASC 54999.93 1\nEPS1 1e-5 1\nEPS2 -2e-5 1\n"),
    "glitch-wave-jump": ("GLEP_1 55200\nGLPH_1 0.2 1\nGLF0_1 1e-7 1\n"
                         "WAVE_OM 0.005\nWAVE1 0.01 -0.02\n"
                         "JUMP -be Y 1e-6 1\n"),
}
ELL1_F2 = CASES["ell1-short-pb"] + "F2 1e-26 1\n"


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _port_problem(extra, n=200, seed=11, be_all=None):
    """tests/test_anchored.py's fixture built by the port: TOAs at 1400
    and 820 MHz over 53001-56999, half of them flagged -be Y."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(io.StringIO(BASE + extra), device=CPU)
        rng = np.random.default_rng(seed)
        mjds = np.sort(rng.uniform(53001, 56999, n))
        toas = make_fake_toas_fromMJDs(
            mjds, model, error_us=1.0,
            freq_mhz=np.tile([1400.0, 820.0], n // 2), add_noise=True,
            rng=rng)
    for i, f in enumerate(toas.flags):
        f["be"] = be_all or ("X" if i % 2 else "Y")
    toas._touch()   # the flags moved: a fresh cache key
    model.invalidate_cache()
    return model, toas


_PAIRS: dict = {}


def _pair(extra, n=100):
    """(reference model, reference TOAs, port model, port TOAs) of one
    fixture, built once: the reference simulates; the port reads the
    reference's par output and carries its TOAs' host columns."""
    key = (extra, n)
    if key not in _PAIRS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rm = r_get_model(io.StringIO(BASE + extra))
            rng = np.random.default_rng(11)
            mjds = np.sort(rng.uniform(53001, 56999, n))
            rt = r_fake(mjds, rm, error_us=1.0,
                        freq_mhz=np.tile([1400.0, 820.0], n // 2),
                        add_noise=True, rng=rng)
            for i, f in enumerate(rt.flags):
                f["be"] = "X" if i % 2 else "Y"
            par = rm.as_parfile()
            rm = r_get_model(io.StringIO(par))
            tm = get_model(io.StringIO(par), device=CPU)
        _PAIRS[key] = (rm, rt, tm, toas_from_columns(rt, CPU))
    return _PAIRS[key]


def _ref_step(rm, rt, flags):
    """The reference's step under ``flags``: its build and its parts
    (phase chain, residuals, Jacobians) eager, its weighted mean and
    ``_gls_core`` compiled, then the float32 Jacobian's unscaling, as its
    ``step_fn`` chains them."""
    with jax.disable_jit(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rparts, rargs, rnames, meta = r_build_fit_parts(rm, rt, **flags)
        parts = rparts(*rargs)

    @jax.jit
    def solve(M, Fv, r0, nvec, valid, eid, tmask, phi, jvar):
        wt = tmask / nvec
        r = r0 - (jnp.sum(r0 * wt) / jnp.sum(wt)) * tmask
        dp, cov, chi2, _ = r_gls_core(M, Fv, phi, r, nvec, valid, eid,
                                      jvar, meta["nseg"],
                                      f32mm=meta["f32mm"])
        return dp, cov, chi2, r[:rt.ntoas]

    dp, cov, chi2, r = (np.asarray(x) for x in
                        solve(*parts, rargs[7], rargs[11]))
    s = np.asarray(meta["sfull"])
    return (dp * s, cov * np.outer(s, s), float(chi2), r), rnames, meta


# ------------------------------------------------------- dd32 substrate


def test_dd32_split_bitwise_and_round_trip():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1e10, 1e10, 100)
    lo = rng.uniform(-1e-8, 1e-8, 100)
    a = pdd.f64_to_dd32(x)
    ra = rdd.f64_to_dd32(x)
    assert a.hi.dtype == np.float32 and np.array_equal(a.hi, ra.hi) \
        and np.array_equal(a.lo, ra.lo)
    back = a.hi.astype(np.float64) + a.lo.astype(np.float64)
    assert np.max(np.abs(back - x) / np.abs(x)) < 3e-14
    t = pdd.f64_to_dd32(torch.as_tensor(x))
    assert t.hi.dtype == torch.float32
    assert np.array_equal(_np(t.hi), ra.hi) and np.array_equal(_np(t.lo),
                                                               ra.lo)
    with jax.disable_jit():
        rd64 = rdd.dd(jnp.asarray(x), jnp.asarray(lo))
        r2 = rdd.dd_to_dd32(rd64)
    d64 = pdd.dd(torch.as_tensor(x), torch.as_tensor(lo))
    assert np.array_equal(_np(d64.hi), np.asarray(rd64.hi))
    p2 = pdd.dd_to_dd32(d64)
    assert np.array_equal(_np(p2.hi), np.asarray(r2.hi))
    assert np.array_equal(_np(p2.lo), np.asarray(r2.lo))
    np2 = pdd.dd_to_dd32(pdd.DD(np.asarray(rd64.hi), np.asarray(rd64.lo)))
    assert np.array_equal(np2.hi, np.asarray(r2.hi))
    v64 = np.asarray(rd64.hi) + np.asarray(rd64.lo)
    back2 = _np(p2.hi).astype(np.float64) + _np(p2.lo).astype(np.float64)
    assert np.max(np.abs(back2 - v64) / np.abs(v64)) < 3e-14


def test_dd_from_parts_keeps_the_dtype():
    h32 = torch.ones(3, dtype=torch.float32)
    l32 = torch.zeros(3, dtype=torch.float32)
    assert pdd.dd_from_parts(h32, l32).hi.dtype == torch.float32
    mixed = pdd.dd_from_parts(h32, torch.zeros(3, dtype=torch.float64))
    assert mixed.hi.dtype == mixed.lo.dtype == torch.float64
    r = rdd.dd_from_parts(np.float64(2.0), 1e-17)
    p = pdd.dd_from_parts(2.0, 1e-17)
    assert float(p.hi) == float(r.hi) and float(p.lo) == float(r.lo)


def test_dd32_ops_bitwise_and_precise():
    """dd_add and dd_mul of dd32 pairs: float32 out, ~2^-48 relative,
    and bitwise the reference's eager ops; two_prod exact in float32."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1e8, 1e8, 500)
    y = rng.uniform(-1e3, 1e3, 500)
    a, b = pdd.f64_to_dd32(x), pdd.f64_to_dd32(y)
    ta = pdd.DD(torch.as_tensor(a.hi), torch.as_tensor(a.lo))
    tb = pdd.DD(torch.as_tensor(b.hi), torch.as_tensor(b.lo))
    s, p = pdd.dd_add(ta, tb), pdd.dd_mul(ta, tb)
    assert s.hi.dtype == p.hi.dtype == torch.float32
    with jax.disable_jit():
        ja = rdd.DD(jnp.asarray(a.hi), jnp.asarray(a.lo))
        jb = rdd.DD(jnp.asarray(b.hi), jnp.asarray(b.lo))
        rs, rp = rdd.dd_add(ja, jb), rdd.dd_mul(ja, jb)
        a32 = jnp.asarray(rng.uniform(-1, 1, 500), jnp.float32)
        b32 = jnp.asarray(rng.uniform(-1, 1, 500), jnp.float32)
        rtp = rdd.two_prod(a32, b32)
    for got, ref in ((s, rs), (p, rp)):
        assert np.array_equal(_np(got.hi), np.asarray(ref.hi))
        assert np.array_equal(_np(got.lo), np.asarray(ref.lo))
    sv = _np(s.hi).astype(np.float64) + _np(s.lo).astype(np.float64)
    pv = _np(p.hi).astype(np.float64) + _np(p.lo).astype(np.float64)
    assert np.max(np.abs(sv - (x + y)) / np.abs(x + y)) < 3e-14
    assert np.max(np.abs(pv - (x * y)) / np.abs(x * y)) < 3e-14
    tp = pdd.two_prod(torch.as_tensor(np.asarray(a32)),
                      torch.as_tensor(np.asarray(b32)))
    assert np.array_equal(_np(tp.hi), np.asarray(rtp.hi))
    assert np.array_equal(_np(tp.lo), np.asarray(rtp.lo))
    exact = np.asarray(a32, np.float64) * np.asarray(b32, np.float64)
    recon = _np(tp.hi).astype(np.float64) + _np(tp.lo).astype(np.float64)
    assert np.max(np.abs(recon - exact)) == 0.0


def test_frac_round_large_lo_bitwise():
    """dd32 at 1e10 turns has ulp(hi) = 1024: the integer strip of
    dd_frac/dd_round must handle |lo| spanning hundreds of units."""
    rng = np.random.default_rng(2)
    ph = rng.uniform(1e9, 1e10, 2000)
    a = pdd.f64_to_dd32(ph)
    ta = pdd.DD(torch.as_tensor(a.hi), torch.as_tensor(a.lo))
    fr, rd = pdd.dd_frac(ta), pdd.dd_round(ta)
    frv = _np(fr.hi).astype(np.float64) + _np(fr.lo).astype(np.float64)
    assert np.max(np.abs(frv - (ph - np.round(ph)))) < 1e-4
    rdv = _np(rd.hi).astype(np.float64) + _np(rd.lo).astype(np.float64)
    assert np.max(np.abs(rdv - np.round(ph))) == 0.0
    with jax.disable_jit():
        ja = rdd.DD(jnp.asarray(a.hi), jnp.asarray(a.lo))
        rfr, rrd = rdd.dd_frac(ja), rdd.dd_round(ja)
    for got, ref in ((fr, rfr), (rd, rrd)):
        assert np.array_equal(_np(got.hi), np.asarray(ref.hi))
        assert np.array_equal(_np(got.lo), np.asarray(ref.lo))
    # float64 pairs unchanged by the large-lo strip
    hi = np.array([2.0, 5e9, -3e9, 55000.75])
    lo = np.array([1e-20, 0.3e-16, -0.3e-16, 1e-18])
    f = pdd.dd_frac(pdd.DD(torch.as_tensor(hi), torch.as_tensor(lo)))
    np.testing.assert_allclose(_np(f.hi) + _np(f.lo),
                               (hi - np.round(hi)) + lo, rtol=0, atol=1e-30)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_taylor_powdiff_matches_reference(dtype):
    """Sum c_i (x^i - y^i)/i! through dxy: bitwise the reference's eager
    evaluation, and the difference of the two series in long double to
    1e-13 (float64) or 1e-5 (float32) of its largest value."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.2e8, 1.2e8, 300)
    dxy = rng.uniform(-500.0, 500.0, 300)
    coeffs = [0.0, 300.123456789, -1e-15, 1e-26, 1e-33]
    T = float(np.max(np.abs(x))) * 1.05
    got = ptaylor.taylor_powdiff(torch.as_tensor(x.astype(dtype)),
                                 torch.as_tensor(dxy.astype(dtype)),
                                 coeffs, t_scale=T)
    with jax.disable_jit():
        ref = rtaylor.taylor_powdiff(jnp.asarray(x.astype(dtype)),
                                     jnp.asarray(dxy.astype(dtype)),
                                     coeffs, t_scale=T)
    assert str(got.dtype).endswith(dtype)
    assert np.array_equal(_np(got), np.asarray(ref))
    xl = x.astype(np.longdouble)
    yl = xl - dxy.astype(np.longdouble)
    exact = sum(np.longdouble(c) * (xl ** i - yl ** i)
                / np.longdouble(math.factorial(i))
                for i, c in enumerate(coeffs) if i and c)
    scale = float(np.max(np.abs(exact)))
    tol = (1e-13 if dtype == "float64" else 1e-5) * scale
    assert np.max(np.abs(_np(got) - exact.astype(np.float64))) < tol


# ---------------------------------------------- routes against the reference


ROUTES = {
    "anchored": dict(anchored=True, jac_f32=False, matmul_f32=False),
    "jac_f32": dict(anchored=False, jac_f32=True, matmul_f32=False),
    "matmul_f32": dict(anchored=False, jac_f32=False, matmul_f32=True),
    "jac_f32-hybrid": dict(anchored=False, jac_f32=True, matmul_f32=False,
                           hybrid_jac=True),
    "production": dict(anchored=True, jac_f32=True, matmul_f32=True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_the_reference_route(route):
    """Each route's step on the ELL1 + F2 fixture against the reference's
    same route: dparams within 1e-4 sigma on a float32 route (1e-6 on the
    float64 anchored route, test_torch_fit's step limit), residuals
    within 1e-12 s, chi2 within 1e-12 relative plus what the residual
    difference explains."""
    flags = ROUTES[route]
    rm, rt, tm, tt = _pair(ELL1_F2)
    ref, rnames, meta = _ref_step(rm, rt, flags)
    _, _, args, names, pmeta = pfs._build_fit_core(tm, tt, device=CPU,
                                                   **flags)
    step = pfs._build_fit_core(tm, tt, device=CPU, **flags)[0]
    got = [_np(x) for x in step(*args)]
    assert names == rnames
    for k in ("anchored", "jac32", "f32mm"):
        assert bool(pmeta[k]) == bool(meta[k]), k
    sig = np.sqrt(np.diag(ref[1]))
    f32 = flags["jac_f32"] or flags["matmul_f32"]
    assert np.max(np.abs(got[0] - ref[0]) / sig) < (1e-4 if f32 else 1e-6)
    dr = got[3] - ref[3]
    assert np.max(np.abs(dr)) < 1e-12
    nvec = np.asarray(tm.scaled_toa_uncertainty(tt)) ** 2
    assert abs(float(got[2]) - ref[2]) <= chi2_tol(ref[2], dr,
                                                    np.sqrt(nvec), 1e-12)


def test_wideband_float32_jacobian_matches_the_reference():
    """The stacked [time; DM] step with the float32 Jacobian (the DM rows
    in float32 at the scaled point) against the reference's."""
    from test_torch_wideband import wideband_problem

    flags = dict(wideband=True, anchored=False, jac_f32=True,
                 matmul_f32=False)
    rm, rt, tm, tt = wideband_problem("isolated")
    ref, rnames, meta = _ref_step(rm, rt, flags)
    step, args, names = build_fit_step(tm, tt, device=CPU, **flags)
    got = [_np(x) for x in step(*args)]
    assert names == rnames and meta["jac32"]
    sig = np.sqrt(np.diag(ref[1]))
    assert np.max(np.abs(got[0] - ref[0]) / sig) < 1e-4
    assert np.max(np.abs(got[3] - ref[3])) < 1e-12


# ------------------------------------------ routes against the port's own


def _own(model, toas, **flags):
    step, args, names = build_fit_step(model, toas, device=CPU, **flags)
    return [_np(x) for x in step(*args)], args, step, names


@pytest.mark.parametrize("case", sorted(CASES))
def test_anchored_equals_direct(case):
    """tests/test_anchored.py: at the anchor and under a compensated
    perturbation, residuals within 1e-11 s, chi2 within 1e-6 relative,
    dparams within 1e-4 sigma."""
    model, toas = _port_problem(CASES[case])
    free = model.free_params
    oD, aD, sD, _ = _own(model, toas, anchored=False, jac_f32=False)
    oA, aA, sA, _ = _own(model, toas, anchored=True, jac_f32=False)
    assert np.max(np.abs(oD[3] - oA[3])) < 1e-11
    assert abs(oD[2] - oA[2]) < 1e-6 * abs(oD[2]) + 1e-9
    sig = np.sqrt(np.diag(oD[1]))
    assert np.max(np.abs(oD[0] - oA[0]) / sig) < 1e-4
    dth = np.zeros(len(free))
    dth[free.index("F0")] = 3e-10
    dth[free.index("F1")] = -2e-18
    dth[free.index("DM")] = 1e-5
    th, tl = _np(aD[0]), _np(aD[1])
    th2 = th + dth
    tl2 = tl + (dth - (th2 - th))
    t = torch.as_tensor
    oD = [_np(x) for x in sD(t(th2), t(tl2), *aD[2:])]
    oA = [_np(x) for x in sA(t(dth), *aA[1:])]
    assert np.max(np.abs(oD[3] - oA[3])) < 1e-11
    assert abs(oD[2] - oA[2]) < 1e-6 * abs(oD[2]) + 1e-9


def test_production_route_against_float64():
    """Anchored + float32 Jacobian + float32 Gram (the reference's TPU
    production configuration) against the plain float64 step."""
    model, toas = _port_problem(ELL1_F2)
    oD, _, _, _ = _own(model, toas, anchored=False, jac_f32=False,
                       matmul_f32=False)
    oA, _, _, _ = _own(model, toas, anchored=True, jac_f32=True,
                       matmul_f32=True)
    sig = np.sqrt(np.diag(oD[1]))
    assert np.max(np.abs(oD[0] - oA[0]) / sig) < 1e-2
    assert np.max(np.abs(oD[3] - oA[3])) < 1e-11


JAC32 = {
    "high-f-terms": ("F2 1e-26 1\nF3 1e-33 1\nF4 1e-42 1\nPMRA 2.0 1\n"
                     "PMDEC -3 1\nPX 1.2 1\n", None),
    "f5-f7": ("F2 1e-26 1\nF3 1e-33 1\nF4 1e-40 1\nF5 1e-48 1\n"
              "F6 1e-56 1\nF7 1e-64 1\n", None),
    "ecorr": (CASES["ecorr-red"], "X"),
    "ell1": (CASES["ell1-short-pb"], None),
    "dd": ("BINARY DD\nPB 67.8 1\nA1 32.3 1\nT0 54999.1 1\nECC 0.27 1\n"
           "OM 120.0 1\nOMDOT 0.01 1\nSINI 0.9 1\nM2 0.3 1\n", None),
    "ell1-fb": ("BINARY ELL1\nFB0 3.05e-5 1\nFB1 -1e-19 1\nA1 1.42 1\n"
                "TASC 54999.93 1\nEPS1 1e-5 1\nEPS2 -2e-5 1\n", None),
}


@pytest.mark.parametrize("case", sorted(JAC32))
def test_f32_jacobian_against_float64(case):
    """tests/test_jac32.py: the float32 Jacobian's step within 1e-2 sigma
    and chi2 within 1e-6 relative of the float64 step."""
    extra, be = JAC32[case]
    model, toas = _port_problem(extra, seed=3, be_all=be)
    o64, _, _, names = _own(model, toas, jac_f32=False)
    o32, _, _, _ = _own(model, toas, jac_f32=True)
    sig = np.sqrt(np.diag(o64[1]))
    assert np.max(np.abs(o64[0] - o32[0]) / sig) < 1e-2, names
    assert abs(o64[2] - o32[2]) <= 1e-6 * abs(o64[2])


def test_f8_falls_back_to_float64():
    """No float32 scale window for F8 over a decade: the build falls back
    to the float64 Jacobian (and, left unset, the float64 Gram)."""
    extra = "".join(f"F{i} 1e-{26 + 7 * (i - 2)} 1\n" for i in range(2, 9))
    model, toas = _port_problem(extra, seed=3)
    _, _, _, _, meta = pfs._build_fit_core(model, toas, device=CPU,
                                           jac_f32=True)
    assert not meta["jac32"] and not meta["f32mm"]
    o32, _, _, _ = _own(model, toas, jac_f32=True)
    o64, _, _, _ = _own(model, toas, jac_f32=False)
    np.testing.assert_allclose(o32[0], o64[0], rtol=1e-12)


def test_jacobian_columns_relative():
    """Every float32 column within 1e-5 of its float64 twin, relative to
    the column max."""
    model, toas = _port_problem(CASES["ell1-short-pb"]
                                + "PMRA 2.0 1\nPMDEC -3 1\n", seed=3)
    phase_fn, (free, _) = model._build_phase_fn()
    cache = model.get_cache(toas, CPU)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    th, tl, fh, fl = (t(x) for x in model._pack()[2:])
    sc = {k: v for k, v in cache.items() if k != "batch"}

    def p64(thx):
        ph, _ = phase_fn(thx, tl, fh, fl, cache["batch"], sc)
        return ph.hi + ph.lo

    jac64 = _np(torch.func.jacfwd(p64)(th))
    b32, sc32 = pfs._tree_to32(cache["batch"]), pfs._tree_to32(sc)
    ua, ub = pfs._split32(th, tl)
    fa, fb = pfs._split32(fh, fl)

    def p32(u):
        ph, _ = phase_fn(u, ub, fa, fb, b32, sc32)
        return ph.hi + ph.lo

    jac32 = _np(torch.func.jacfwd(p32)(ua)).astype(np.float64)
    for j, nm in enumerate(free):
        cmax = np.max(np.abs(jac64[:, j]))
        assert np.max(np.abs(jac64[:, j] - jac32[:, j])) < 1e-5 * cmax, nm


class _Dtypes(TorchDispatchMode):
    """Every op's output dtypes."""

    def __init__(self):
        super().__init__()
        self.f64 = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(o, torch.Tensor) and o.dtype == torch.float64:
                self.f64.append(str(func))
        return out


def test_f32_chain_has_zero_f64_ops():
    """The float32 phase function is pure float32: one float64 constant
    (a Python number made a float64 tensor by a dd helper) would drag the
    whole chain downstream back to float64."""
    extra = ("F2 1e-26 1\nBINARY ELL1\nPB 0.38 1\nA1 1.42 1\n"
             "TASC 54999.93 1\nEPS1 1e-5 1\nEPS2 -2e-5 1\n")
    model, toas = _port_problem(extra, n=100, seed=3)
    phase_fn, _ = model._build_phase_fn()
    cache = model.get_cache(toas, CPU)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    th, tl, fh, fl = (t(x) for x in model._pack()[2:])
    b32 = pfs._tree_to32(cache["batch"])
    sc32 = pfs._tree_to32({k: v for k, v in cache.items() if k != "batch"})
    ua, ub = pfs._split32(th, tl)
    fa, fb = pfs._split32(fh, fl)
    with _Dtypes() as rec:
        ph, _ = phase_fn(ua, ub, fa, fb, b32, sc32)
        out = ph.hi + ph.lo
    assert out.dtype == torch.float32
    assert not rec.f64, f"float64 ops in the float32 chain: {rec.f64[:10]}"


# ------------------------------------------------ flags, gating, fitters


def test_env_overrides_and_auto(monkeypatch, caplog):
    """Explicit > $PINT_TPU_* (f32/f64/on/off) > auto, auto float64 off a
    TPU; an unparsable value warns once and counts as unset."""
    for fn, env in ((pfs._use_f32_jac, "PINT_TPU_JAC"),
                    (pfs._use_f32_matmul, "PINT_TPU_GLS_MATMUL"),
                    (pfs._use_anchored, "PINT_TPU_ANCHORED")):
        assert fn(None) is False
        monkeypatch.setenv(env, "f32")
        assert fn(None) is True and fn(False) is False
        monkeypatch.setenv(env, "off")
        assert fn(None) is False and fn(True) is True
        monkeypatch.setenv(env, "sideways")
        assert config.f32_mode(env) is None and fn(None) is False
        monkeypatch.delenv(env)
    monkeypatch.setenv("PINT_TPU_JAC", "on")
    _, _, _, _, meta = pfs._build_fit_core(*_port_problem("", n=40),
                                           device=CPU)
    assert meta["jac32"] and meta["f32mm"]   # the unset Gram follows
    monkeypatch.setenv("PINT_TPU_GLS_MATMUL", "f64")
    _, _, _, _, meta = pfs._build_fit_core(*_port_problem("", n=40),
                                           device=CPU)
    assert meta["jac32"] and not meta["f32mm"]


def test_drift_band_follows_the_routes(monkeypatch):
    assert config.health_drift_sigma() == 1e-5
    monkeypatch.setenv("PINT_TPU_ANCHORED", "on")
    assert config.health_drift_sigma() == 1e-5
    monkeypatch.setenv("PINT_TPU_GLS_MATMUL", "f32")
    assert config.health_drift_sigma() == 2e-2
    monkeypatch.setenv("PINT_TPU_HEALTH_DRIFT_SIGMA", "3e-3")
    assert config.health_drift_sigma() == 3e-3


def test_default_step_is_the_float64_step():
    """Every flag None and no environment: the float64 route, bitwise
    the explicit float64 build."""
    model, toas = _port_problem(ELL1_F2, n=60)
    a, _, _, _ = _own(model, toas)
    b, _, _, _ = _own(model, toas, anchored=False, jac_f32=False,
                      matmul_f32=False)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_supports_anchored_gating_and_fallbacks(monkeypatch, caplog):
    model, toas = _port_problem("", n=60)
    assert model.supports_anchored()
    model.get_param("PEPOCH").frozen = False
    assert not model.supports_anchored()
    with pytest.raises(ValueError):
        model.build_anchor(toas)
    # anchored=True on an unsupported model takes the direct chain
    _, _, args, _, meta = pfs._build_fit_core(model, toas, device=CPU,
                                              anchored=True)
    assert not meta["anchored"] and np.any(_np(args[0]) != 0)
    model.get_param("PEPOCH").frozen = True

    # a failing anchor build warns and falls back, as the reference does
    def broken(*a, **k):
        raise RuntimeError("no anchor")

    monkeypatch.setattr(type(model), "build_anchor", broken)
    with caplog.at_level("WARNING"):
        step, _, args, _, meta = pfs._build_fit_core(
            model, toas, device=CPU, anchored=True)
    assert not meta["anchored"]
    assert "falling back to the direct phase chain" in caplog.text
    assert np.isfinite(float(step(*args)[2]))


def test_grid_chisq_anchored_matches(monkeypatch):
    """grid_chisq varies frozen parameters through the step's fh/fl
    slots: anchored, the surface is the direct one (not flat at the build
    point)."""
    model, toas = _port_problem("", n=150)
    f0 = model.F0.value
    grid = np.linspace(f0 - 2e-9, f0 + 2e-9, 5)
    monkeypatch.setenv("PINT_TPU_ANCHORED", "off")
    c_direct = grid_chisq(model, toas, ["F0"], [grid])
    monkeypatch.setenv("PINT_TPU_ANCHORED", "on")
    c_anch = grid_chisq(model, toas, ["F0"], [grid])
    assert np.ptp(c_direct) > 1.0
    np.testing.assert_allclose(c_anch, c_direct, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fitter", ["device", "streaming"])
def test_fitters_take_the_routes(fitter):
    """DeviceDownhillGLSFitter and StreamingGLSFitter under each route:
    anchored (th, tl) deltas against the zeroed build slots reach the
    same fit as the direct route; the float32 routes within 1e-2
    sigma."""
    model, toas = _port_problem(CASES["ecorr-red"], n=150, be_all="X")
    fits = {}
    for name, flags in (("f64", {}), ("anchored", dict(anchored=True)),
                        ("production", dict(anchored=True, jac_f32=True,
                                            matmul_f32=True))):
        m = copy.deepcopy(model)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if fitter == "device":
                f = DeviceDownhillGLSFitter(toas, m, **flags)
            else:
                f = StreamingGLSFitter(toas, m, chunk=64, **flags)
            chi2 = f.fit_toas()
        fits[name] = (chi2, np.array([m.get_param(n).value
                                      for n in m.free_params]),
                      np.array([m.get_param(n).uncertainty
                                for n in m.free_params]))
    chi2, v, s = fits["f64"]
    assert np.max(np.abs(fits["anchored"][1] - v) / s) < 1e-6
    assert abs(fits["anchored"][0] - chi2) < 1e-8 * chi2
    assert np.max(np.abs(fits["production"][1] - v) / s) < 1e-2


def test_float32_gram_rescue_takes_the_float64_solve():
    """A nearly degenerate design: the float32 Gram loses positive
    definiteness, and the step's solve is the float64 one, bitwise; a
    well-conditioned one keeps the float32 solve."""
    rng = np.random.default_rng(5)
    n = 400
    x = rng.normal(size=n)
    y = rng.normal(size=n)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    M = t(np.stack([np.ones(n), x, x + 1e-5 * y], axis=1))
    F = t(np.zeros((n, 0)))
    phi = t(np.ones(0))
    r = t(rng.normal(size=n))
    nvec = t(np.ones(n))
    valid = t(np.ones(n))
    jvar = t(np.zeros(1))
    lo = pfs._gls_core(M, F, phi, r, nvec, valid, jvar)
    hi = pfs._gls_core(M, F, phi, r, nvec, valid, jvar, f32mm=True)
    assert all(torch.equal(a, b) for a, b in zip(lo, hi))
    good = t(np.stack([np.ones(n), x, y], axis=1))
    lo = pfs._gls_core(good, F, phi, r, nvec, valid, jvar)
    hi = pfs._gls_core(good, F, phi, r, nvec, valid, jvar, f32mm=True)
    assert not torch.equal(lo[0], hi[0])
    sig = torch.sqrt(torch.diagonal(lo[1]))
    assert float(torch.max(torch.abs(lo[0] - hi[0]) / sig)) < 1e-4


def test_gls_fitter_float32_gram(monkeypatch):
    """GLSFitter's Cholesky solve takes the float32 Gram under
    $PINT_TPU_GLS_MATMUL=f32, within 1e-2 sigma of the float64 solve;
    its kernel's f32mm output holds to the reference kernel's."""
    from pint_tpu.gls import _gls_kernel as r_kernel
    from pint_tpu_torch.gls import GLSFitter, _gls_kernel

    model, toas = _port_problem(CASES["ecorr-red"], n=150, be_all="X")
    base = copy.deepcopy(model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        GLSFitter(toas, base).fit_toas()
        monkeypatch.setenv("PINT_TPU_GLS_MATMUL", "f32")
        m32 = copy.deepcopy(model)
        GLSFitter(toas, m32).fit_toas()
    for nm in base.free_params:
        p, q = base.get_param(nm), m32.get_param(nm)
        assert abs(p.value - q.value) < 1e-2 * p.uncertainty, nm
    rng = np.random.default_rng(6)
    M = rng.normal(size=(200, 4)) * np.array([1.0, 1e3, 1e-3, 10.0])
    Fb = rng.normal(size=(200, 3))
    phi = np.array([1e-12, 1e-13, 1e-14])
    r = rng.normal(size=200) * 1e-6
    nvec = np.full(200, 1e-12)
    ref = r_kernel(*(jnp.asarray(a) for a in (M, Fb, phi, r, nvec)),
                   f32mm=True)
    got = _gls_kernel(*(torch.as_tensor(a) for a in (M, Fb, phi, r, nvec)),
                      f32mm=True)
    sig = np.sqrt(np.diag(np.asarray(ref[1])))
    assert np.max(np.abs(_np(got[0]) - np.asarray(ref[0])) / sig) < 1e-4
