"""The TOA-sharded fit step of the port (``build_sharded_fit_step`` over a
``pta.shard.Mesh``) on the CPU: the port's counterparts of
tests/test_sharded_fit_step.py, test_anchored.py's
``test_anchored_sharded_equals_unsharded`` and test_wideband_step.py's
``test_sharded_wideband``.

The meshes here hold CPU "devices" (``Mesh(np.array([cpu] * 8),
("toa",))``, 8 blocks unless a test says otherwise), as the reference's
conftest gives its tests 8 virtual XLA devices on one CPU. The sharded step is held to the unsharded step at
tests/test_sharded_fit_step.py's tolerances (dparams rtol 1e-7 / atol
1e-14, cov rtol 1e-7, chi2 rel 1e-8, residuals rtol 1e-7 / atol 1e-12 s,
pad rows exactly 0); a one-shard mesh gives the unsharded step bitwise.
Against the reference's sharded step, jitted on its 8 virtual devices,
the same tolerances hold, with chi2 held as tests/test_torch_fit.py holds
a step's chi2 (``chi2_tol``: the two libraries round some delays one
ulp apart, ~3e-14 s). The float32 routes are held in sigma, at the
reference's limits (1e-3 sigma, chi2 1e-5 relative)."""

import copy
import io
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pint_tpu.models import get_model as r_get_model
from pint_tpu.parallel import build_sharded_fit_step as r_sharded
from pint_tpu.simulation import make_fake_toas_fromMJDs as r_fake_mjds
from pint_tpu.simulation import make_fake_toas_uniform as r_fake_uniform
from pint_tpu.toa import merge_TOAs as r_merge

from pint_tpu_torch import obs
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_fit_step, build_sharded_fit_step, \
    toa_sharding
from pint_tpu_torch.parallel.fit_step import SegmentSum
from pint_tpu_torch.pta.shard import Blocks, Mesh
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.runtime import get_supervisor

from test_torch_fit import chi2_tol

CPU = torch.device("cpu")
DP_RTOL, DP_ATOL, COV_RTOL, CHI2_REL, R_RTOL, R_ATOL = \
    1e-7, 1e-14, 1e-7, 1e-8, 1e-7, 1e-12

# tests/test_sharded_fit_step.py's fixture
PAR = ["PSR J0001+0001", "RAJ 11:00:00.0 1", "DECJ 20:00:00.0 1",
       "F0 250.0 1", "F1 -2e-15 1", "PEPOCH 55000", "POSEPOCH 55000",
       "DM 15.0 1", "DMEPOCH 55000", "TZRMJD 55000.1", "TZRSITE @",
       "TZRFRQ 1400", "UNITS TDB", "EFAC -be X 1.1", "ECORR -be X 0.7",
       "TNREDAMP -13.5", "TNREDGAM 3.0", "TNREDC 5"]


def cpu_mesh(k: int, axis: str = "toa") -> Mesh:
    return Mesh(np.array([CPU] * k).reshape(k), (axis,))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def problem():
    """(reference model, reference TOAs, port model, port TOAs): 40 + 37
    TOAs merged into one -be X group (77: pads to 80 over 8 shards, and
    ECORR epochs straddle the shard boundaries)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = r_get_model(io.StringIO("\n".join(PAR) + "\n"))
        rng = np.random.default_rng(7)
        tA = r_fake_uniform(54001, 55901, 40, model, error_us=1.0,
                            freq_mhz=1400.0, add_noise=True, rng=rng)
        tB = r_fake_uniform(54002, 55902, 37, model, error_us=1.5,
                            freq_mhz=820.0, add_noise=True, rng=rng)
        toas = r_merge([tA, tB])
        for f in toas.flags:
            f["be"] = "X"
        tm = get_model(io.StringIO(model.as_parfile()), device=CPU)
    return model, toas, tm, toas_from_columns(toas, CPU)


@pytest.fixture(scope="module")
def clustered():
    """The same pulsar at 77 TOAs in ECORR epochs: one TOA, then 38
    same-day pairs, so over 8 shards of 10 rows the pairs straddle
    every block boundary."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = r_get_model(io.StringIO("\n".join(PAR) + "\n"))
        rng = np.random.default_rng(7)
        base = np.linspace(54010, 55900, 38)
        mjds = np.concatenate([[54001.0], np.sort(np.concatenate(
            [base, base + 0.003]))])
        toas = r_fake_mjds(mjds, model, error_us=1.0,
                           freq_mhz=np.tile([1400.0, 820.0], 39)[:77],
                           add_noise=True, rng=rng, flags={"be": "X"})
        tm = get_model(io.StringIO(model.as_parfile()), device=CPU)
    return model, toas, tm, toas_from_columns(toas, CPU)


def _check_close(got, want, n):
    """test_sharded_fit_step.py's limits, ``got`` the sharded step's
    outputs (resids padded), ``want`` the unsharded step's."""
    got, want = [_np(x) for x in got], [_np(x) for x in want]
    np.testing.assert_allclose(got[0], want[0], rtol=DP_RTOL, atol=DP_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=COV_RTOL)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=CHI2_REL)
    np.testing.assert_allclose(got[3][:n], want[3][:n], rtol=R_RTOL,
                               atol=R_ATOL)
    np.testing.assert_array_equal(got[3][n:], 0.0)


def test_sharded_matches_unsharded(problem):
    _, _, tm, tt = problem
    step, args, names = build_fit_step(tm, tt, device=CPU)
    want = step(*args)
    sup, dev_args, names_s = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    got = sup(*dev_args)
    assert names_s == names
    assert got[3].shape == (80,)
    _check_close(got, want, tt.ntoas)


@pytest.mark.parametrize("flags", [
    {}, {"health": True}, {"jac_f32": True, "matmul_f32": True},
    {"anchored": True}, {"hybrid_jac": True}],
    ids=["float64", "health", "float32", "anchored", "hybrid"])
def test_one_shard_is_bitwise_the_step(problem, flags):
    _, _, tm, tt = problem
    step, args, names = build_fit_step(tm, tt, device=CPU, **flags)
    want = step(*args)
    sup, dev_args, names_s = build_sharded_fit_step(tm, tt, cpu_mesh(1),
                                                    **flags)
    got = sup(*dev_args)
    assert names_s == names and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_epochs_straddle_the_shard_boundaries(clustered):
    """ECORR epochs that cross block edges: each block's segment sums
    are partial vectors over the global epochs, summed before g is
    formed; the sharded step agrees with the unsharded one."""
    _, _, tm, tt = clustered
    nseg = tm.noise_model_ecorr_segments(tt)[1].shape[0]
    assert nseg == 39   # 38 epochs and the 'no epoch' slot
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    eids = [_np(e) for e in dev_args[10]]
    straddle = [i for i in range(7)
                if eids[i][-1] == eids[i + 1][0] and eids[i][-1] < nseg - 1]
    assert straddle == list(range(7))
    plans = [SegmentSum(e, nseg) for e in dev_args[10]]
    ones = [torch.ones(e.shape[0], dtype=torch.float64)
            for e in dev_args[10]]
    total = sum(p(o) for p, o in zip(plans, ones))
    whole = SegmentSum(torch.cat(list(dev_args[10])), nseg)(
        torch.ones(80, dtype=torch.float64))
    assert torch.equal(total, whole)
    step, args, _ = build_fit_step(tm, tt, device=CPU)
    _check_close(sup(*dev_args), step(*args), tt.ntoas)


@pytest.mark.parametrize("fixture", ["problem", "clustered"])
def test_sharded_matches_the_reference_sharded_step(fixture, request):
    """Against the reference's sharded step jitted on its 8 virtual
    devices (XLA's GSPMD partitioning of the same algebra)."""
    rm, rt, tm, tt = request.getfixturevalue(fixture)
    devs = jax.devices()
    assert len(devs) == 8, "the conftest provides 8 virtual devices"
    rjit, rargs, rnames = r_sharded(rm, rt, JaxMesh(np.array(devs), ("toa",)))
    want = [np.asarray(x) for x in rjit(*rargs)]
    sup, dev_args, names = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    got = [_np(x) for x in sup(*dev_args)]
    assert names == rnames
    n = tt.ntoas
    np.testing.assert_allclose(got[0], want[0], rtol=DP_RTOL, atol=DP_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=COV_RTOL)
    sigma = tm.scaled_toa_uncertainty(tt) * 1e-6
    assert abs(got[2] - want[2]) <= chi2_tol(
        want[2], got[3][:n] - want[3][:n], sigma, CHI2_REL)
    np.testing.assert_allclose(got[3][:n], want[3][:n], rtol=R_RTOL,
                               atol=R_ATOL)
    np.testing.assert_array_equal(got[3][n:], 0.0)
    np.testing.assert_array_equal(want[3][n:], 0.0)


def test_sharded_step_improves_chi2(problem):
    """One sharded GLS step from a perturbed F0 lowers the basis-
    marginalized chi2 and lands F0 back within 1e-11 Hz."""
    _, _, tm, tt = problem
    m = copy.deepcopy(tm)
    m.get_param("F0").add_delta(3e-10)
    m.invalidate_cache(params_only=True)
    chi2_before = float(Residuals(tt, m).chi2)
    sup, dev_args, names = build_sharded_fit_step(m, tt, cpu_mesh(8))
    dp = _np(sup(*dev_args)[0])
    for name, dx in zip(names, dp):
        if name != "Offset":
            m.get_param(name).add_delta(float(dx))
    m.invalidate_cache(params_only=True)
    assert float(Residuals(tt, m).chi2) < chi2_before
    assert abs(m.F0.value - tm.F0.value) < 1e-11


def test_health_vector_across_shards(problem):
    _, _, tm, tt = problem
    step, args, _ = build_fit_step(tm, tt, device=CPU, health=True)
    want = _np(step(*args)[4])
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8),
                                              health=True)
    got = _np(sup(*dev_args)[4])
    assert got[0] == want[0] == 0.0
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    assert got[2] == pytest.approx(want[2], rel=CHI2_REL)


def _precision_problem(extra, n, wideband=False):
    """The port's model and TOAs of tests/test_anchored.py's fixture
    (``extra`` par lines, n TOAs) or, with ``wideband``, of
    tests/test_wideband_step.py's."""
    from test_torch_precision_routes import _port_problem
    from test_wideband_step import _problem

    if not wideband:
        return _port_problem(extra, n=n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm, rt = _problem(n=n)
        tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    return tm, toas_from_columns(rt, CPU)


def _sigma_dist(got, want):
    sig = np.sqrt(np.diag(_np(want[1])))
    return np.max(np.abs(_np(got[0]) - _np(want[0])) / sig)


def test_anchored_sharded_equals_unsharded():
    """test_anchored.py's case: anchored + float32 Jacobian, 8 shards
    against the unsharded step, in sigma (float32 sums reorder across
    shards)."""
    from test_torch_precision_routes import CASES

    tm, tt = _precision_problem(CASES["ecorr-red"], 200)
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8),
                                              anchored=True, jac_f32=True)
    step, args, _ = build_fit_step(tm, tt, device=CPU, anchored=True,
                                   jac_f32=True)
    got, want = sup(*dev_args), step(*args)
    assert _sigma_dist(got, want) < 1e-3
    assert abs(float(got[2]) - float(want[2])) < 1e-5 * abs(float(want[2]))


@pytest.mark.parametrize("flags,limit", [
    ({}, 1e-9), ({"anchored": True, "jac_f32": True}, 1e-3)],
    ids=["float64", "anchored-float32"])
def test_sharded_wideband(flags, limit):
    """test_wideband_step.py's case (and its float64 twin): the stacked
    [time; DM] step over 8 shards, each shard stacking its own rows."""
    tm, tt = _precision_problem("", 200, wideband=True)
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8),
                                              wideband=True, **flags)
    step, args, _ = build_fit_step(tm, tt, device=CPU, wideband=True,
                                   **flags)
    got, want = sup(*dev_args), step(*args)
    assert _sigma_dist(got, want) < limit
    assert got[3].shape == want[3].shape == (tt.ntoas,)
    if not flags:
        _check_close(got, want, tt.ntoas)


def test_float32_gram_partials_reduce_in_float64(problem):
    """matmul_f32: each shard's Gram is a float32 product, the partials
    are summed in float64; the step stays within the reference's sharded
    float32 limits of the unsharded float32-Gram step."""
    _, _, tm, tt = problem
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8),
                                              matmul_f32=True)
    step, args, _ = build_fit_step(tm, tt, device=CPU, matmul_f32=True)
    got, want = sup(*dev_args), step(*args)
    assert got[1].dtype == torch.float64
    assert _sigma_dist(got, want) < 1e-3
    assert abs(float(got[2]) - float(want[2])) < 1e-5 * abs(float(want[2]))


def test_toa_axis_is_named_by_structure(problem):
    """Leaves are split by the rule, not by their length: a TZR entry
    whose dim 0 is N is replicated, a TOA-axis entry whose dim 0 is not
    N raises, and so does a cache entry with no rule."""
    _, _, tm, tt = problem
    plan = toa_sharding(cpu_mesh(4))
    n = 80
    odd = torch.arange(n, dtype=torch.float64)
    cache = {"main": {"col": odd}, "tzr": {"col": odd},
             "anchor": {"r_ref": odd, "d_ref_tzr": odd}}
    per = plan.split_cache(cache, n)
    assert [tuple(p["main"]["col"].shape) for p in per] == [(20,)] * 4
    assert all(p["tzr"]["col"] is odd for p in per)
    assert all(p["anchor"]["d_ref_tzr"] is odd for p in per)
    assert torch.equal(torch.cat([p["anchor"]["r_ref"] for p in per]), odd)
    with pytest.raises(ValueError, match="not 80 long"):
        plan.split_cache({"main": {"col": odd[:40]}}, n)
    with pytest.raises(ValueError, match="no TOA-axis rule"):
        plan.split_cache({"extra": odd}, n)
    # the planet stack is split on its TOA axis (dim 1)
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    pl = [b.obs_planet_pos for b in dev_args[4]]
    assert all(x.shape[1] == 10 and x.shape[0] == pl[0].shape[0]
               for x in pl)
    assert all(isinstance(dev_args[i], Blocks) for i in (4, 5, 6, 8, 9, 10))
    assert all(torch.is_tensor(dev_args[i]) for i in (0, 1, 2, 3, 7, 11))


def test_sharded_step_is_supervised(problem):
    """The call is a supervised dispatch under key and span
    ``fit_step.sharded``; ``.step`` is the undispatched step."""
    _, _, tm, tt = problem
    sup, dev_args, _ = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    obs.reset()
    tr = obs.configure(enabled=True)
    before = get_supervisor().metrics.dispatches
    out = sup(*dev_args)
    assert get_supervisor().metrics.dispatches == before + 1
    names = {r.get("name") for r in tr.records()}
    obs.reset()
    assert {"fit_step.sharded", "dispatch/fit_step.sharded"} <= names
    raw = sup.step(*dev_args)
    for a, b in zip(out, raw):
        assert torch.equal(a, b)


@pytest.mark.slow
@pytest.mark.parametrize("n", [32768, 131072])
def test_long_context_sharded_step(n):
    """tests/test_sharded_fit_step.py's long-context case: 32k and 131k
    TOAs over 8 shards, against the unsharded step (chi2 rel 1e-9,
    dparams 1e-6 sigma)."""
    par = ["PSR J0002+0002", "RAJ 09:00:00.0 1", "DECJ 10:00:00.0 1",
           "F0 311.0 1", "F1 -3e-15 1", "PEPOCH 55000", "POSEPOCH 55000",
           "DM 21.0 1", "DMEPOCH 55000", "TZRMJD 55000.1", "TZRSITE @",
           "TZRFRQ 1400", "UNITS TDB", "EFAC -be X 1.05",
           "TNREDAMP -13.6", "TNREDGAM 3.2", "TNREDC 15"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm = r_get_model(io.StringIO("\n".join(par) + "\n"))
        rng = np.random.default_rng(13)
        mjds = np.sort(rng.uniform(53000, 57000, n))
        rt = r_fake_mjds(mjds, rm, error_us=1.0,
                         freq_mhz=np.tile([1400.0, 820.0], n // 2),
                         add_noise=True, rng=rng, flags={"be": "X"})
        tm = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    tm.F0.value += 1e-10
    tm.invalidate_cache(params_only=True)
    tt = toas_from_columns(rt, CPU)
    sup, dev_args, names_s = build_sharded_fit_step(tm, tt, cpu_mesh(8))
    out_s = sup(*dev_args)
    step, args, names = build_fit_step(tm, tt, device=CPU)
    out = step(*args)
    assert names_s == names
    assert float(out_s[2]) == pytest.approx(float(out[2]), rel=1e-9)
    sig = np.sqrt(np.abs(np.diag(_np(out[1]))))
    sig = np.where(sig > 0, sig, 1.0)
    np.testing.assert_allclose((_np(out_s[0]) - _np(out[0])) / sig, 0.0,
                               atol=1e-6)
