"""The pulsar-axis mesh of the port on the CPU: the block plan
(``pta.shard``), ``pta_solve``/``fit_pta`` over a pulsar mesh, the GWB
blocks over a mesh and a mesh serve engine, the port's counterparts of
tests/test_pta.py::test_pta_solve_on_pulsar_mesh,
test_pta_scaleup.py::test_pta_heterogeneous_batch_on_mesh,
test_gwb.py::test_sharded_blocks_match_plain and
test_serve.py::test_mesh_engine_matches_local, on their inputs.

Every mesh holds 8 CPU "devices", as the reference's conftest gives its
tests 8 virtual XLA devices. Tolerances are the reference tests' own:
the mesh solve within rtol 1e-9 / atol 1e-18 of the plain one (here it
is bitwise: every block runs the same batched ops on its rows), the GWB
blocks within 1e-9 (rdr and logdet 1e-10), the mesh engine within the
pta mesh test's limits; the mesh solve against the reference's mesh
solve within tests/test_torch_pta.py's limits (rtol 1e-8, atol 1e-15)."""

import io
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pint_tpu.parallel import build_problem as r_build_problem
from pint_tpu.parallel import pta_solve as r_pta_solve
from pint_tpu.parallel import stack_problems as r_stack_problems

from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_problem, fit_pta, pta_solve, \
    stack_problems
from pint_tpu_torch.parallel.pta import read_back
from pint_tpu_torch.pta import GWBLikelihood
from pint_tpu_torch.pta import shard
from pint_tpu_torch.pta.shard import Blocks, Mesh, batch_sharding, \
    compile_with_plan, mesh_devices, mesh_fingerprint, pad_batch, \
    plan_cache_clear

from test_pta import _mk

CPU = torch.device("cpu")


def cpu_mesh(k: int = 8, axis: str = "pulsar") -> Mesh:
    return Mesh(np.array([CPU] * k).reshape(k), (axis,))


def _port_pair(m, t):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (toas_from_columns(t, CPU),
                get_model(io.StringIO(m.as_parfile()), device=CPU))


# ------------------------------------------------------------ the plan


def test_mesh_shape_and_devices():
    devs = np.array([CPU] * 8)
    mesh = Mesh(devs.reshape(8), ("toa",))
    assert mesh.shape == {"toa": 8} and mesh.axis_names == ("toa",)
    assert mesh.devices.shape == (8,)
    assert all(d == CPU for d in mesh.devices.flat)
    two = Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("x", "pulsar"))
    assert two.shape == {"x": 2, "pulsar": 4}
    assert mesh_devices(two, "pulsar") == (CPU,) * 4
    assert mesh_devices(two, "x") == (CPU,) * 2
    with pytest.raises(ValueError, match="no axis"):
        mesh_devices(two, "toa")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(devs.reshape(2, 4), ("pulsar",))
    with pytest.raises(TypeError, match="Mesh"):
        mesh_devices(object(), "pulsar")


def test_mesh_naming_a_missing_device_raises():
    if torch.cuda.device_count() > 7:
        pytest.skip("this machine has a cuda:7")
    with pytest.raises(ValueError, match="does not exist"):
        Mesh(np.array(["cpu", "cuda:7"]), ("pulsar",))
    with pytest.raises(ValueError, match="cpu and cuda"):
        Mesh(np.array(["meta"]), ("pulsar",))


def test_batch_sharding_is_contiguous_blocks():
    plan = batch_sharding(cpu_mesh(4), "pulsar", 12)
    assert [(b.start, b.stop) for b in plan] == \
        [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert all(b.device == CPU for b in plan)
    with pytest.raises(ValueError, match="pad_batch"):
        batch_sharding(cpu_mesh(4), "pulsar", 10)


def test_compile_with_plan_one_plan_per_key():
    """One plan per (name, mesh devices, axis, donation, ranks); two Mesh
    wrappers over the same devices share it; no mesh is fn itself."""
    plan_cache_clear()

    def fn(a):
        return (a * 2.0,)

    kw = dict(name="t.double", ndims_in=(2,), ndims_out=(2,))
    assert compile_with_plan(fn, **kw) is fn
    p1 = compile_with_plan(fn, mesh=cpu_mesh(), **kw)
    assert compile_with_plan(fn, mesh=cpu_mesh(), **kw) is p1
    assert mesh_fingerprint(cpu_mesh(), "pulsar") == \
        mesh_fingerprint(cpu_mesh(), "pulsar")
    assert compile_with_plan(fn, mesh=cpu_mesh(4), **kw) is not p1
    assert compile_with_plan(fn, mesh=cpu_mesh(axis="x"), axis="x",
                             **kw) is not p1
    assert compile_with_plan(fn, mesh=cpu_mesh(), donate_argnums=(0,),
                             **kw) is not p1
    assert len(shard._PLANS) == 5
    x = np.arange(24.0).reshape(8, 3)
    out = p1(x)
    assert isinstance(out[0], Blocks) and len(out[0]) == 8
    assert all(b.shape == (1, 3) for b in out[0])
    np.testing.assert_array_equal(read_back(out)[0], 2.0 * x)
    with pytest.raises(ValueError, match="ranks"):
        p1(np.arange(8.0))
    plan_cache_clear()
    assert not shard._PLANS


def test_read_back_keeps_plain_outputs():
    """A tuple of plain tensors comes back as before: one copy, the
    shapes kept; Blocks and tensors mix."""
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(4)
    ra, rb = read_back((a, b))
    np.testing.assert_array_equal(ra, a.numpy())
    np.testing.assert_array_equal(rb, b.numpy())
    mix = read_back((Blocks([a[:1], a[1:]]), b))
    np.testing.assert_array_equal(mix[0], a.numpy())


def test_pad_batch_pads_to_the_mesh():
    arrs = {"M": np.ones((3, 2, 2)), "nvec": np.full((3, 2), 2.0)}
    out = pad_batch(arrs, cpu_mesh(4))
    assert out["M"].shape[0] == 4 and not out["M"][3].any()
    assert np.all(out["nvec"][3] == 1.0)
    assert pad_batch(arrs, None)["M"] is arrs["M"]


# ---------------------------------------------------------- batch solve


def test_pta_solve_on_pulsar_mesh():
    """tests/test_pta.py's case: two fresh pulsars, padded to 8 slots
    over the mesh; the mesh solve is the plain one bitwise, and the
    reference's mesh solve within rtol 1e-8 / atol 1e-15."""
    fresh = [_mk("J0011+01", 99.7, 30, 21, perturb=1e-10),
             _mk("J0012+02", 401.3, 48, 22, perturb=-3e-10)]
    ref_problems = [r_build_problem(t, m) for m, t, _ in fresh]
    st = r_stack_problems(ref_problems)
    plain = pta_solve(st, device=CPU)
    sharded = pta_solve(st, mesh=cpu_mesh())
    for a, b in zip(plain, sharded):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-18)
        np.testing.assert_array_equal(a, b)
    ref = r_pta_solve(st, mesh=JaxMesh(np.array(jax.devices()),
                                       ("pulsar",)))
    for a, b in zip(sharded, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-15)
    # the port's own problems of the same pulsars, too
    st_p = stack_problems([build_problem(*_port_pair(m, t))
                           for m, t, _ in fresh])
    for a, b in zip(pta_solve(st_p, device=CPU),
                    pta_solve(st_p, mesh=cpu_mesh())):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-18)


def _scaleup_pairs():
    from test_pta_scaleup import _mk_pulsar

    families = ["plain"] * 10 + ["ell1"] * 3 + ["noise"] * 3
    out = []
    for k, fam in enumerate(families):
        m, t, truth = _mk_pulsar(k, fam)
        tt, tm = _port_pair(m, t)
        out.append((tt, tm, truth))
    return out


def test_pta_heterogeneous_batch_on_mesh():
    """tests/test_pta_scaleup.py's batch: 16 pulsars (10 plain, 3 ELL1,
    3 with EFAC/ECORR/red noise), fit over the 8-shard mesh: per-pulsar
    recovery at its limits (30 of 32 F0/DM within 5 sigma, the binaries'
    A1 too), and the same fit as on one device."""
    pairs = _scaleup_pairs()
    res = fit_pta([(t, m) for t, m, _ in pairs], maxiter=3,
                  mesh=cpu_mesh())
    assert len(res) == 16
    stats = fit_pta.last_stats
    assert stats["npulsars"] == 16 and stats["toas_per_sec"] > 0
    n_ok = 0
    for (t, m, truth), r in zip(pairs, res):
        assert np.isfinite(r["chi2"]) and r["chi2"] > 0
        for pname in ("F0", "DM"):
            err = r["errors"][pname]
            assert err > 0
            n_ok += abs(m.get_param(pname).value - truth[pname]) < 5 * err
    assert n_ok >= 30, f"only {n_ok}/32 parameters recovered"
    for (t, m, truth), r in list(zip(pairs, res))[10:13]:
        assert abs(m.get_param("A1").value - truth["A1"]) \
            < 5 * r["errors"]["A1"]
    # the same batch on one device: the same fit
    plain = _scaleup_pairs()
    res1 = fit_pta([(t, m) for t, m, _ in plain], maxiter=3, device=CPU)
    for r, r1, (_, m, _), (_, m1, _) in zip(res, res1, pairs, plain):
        assert r["chi2"] == pytest.approx(r1["chi2"], rel=1e-9)
        for pname, err in r["errors"].items():
            assert err == pytest.approx(r1["errors"][pname], rel=1e-9)
            assert abs(m.get_param(pname).value
                       - m1.get_param(pname).value) < 1e-6 * err


def test_mesh_arguments_are_checked():
    st = stack_problems([build_problem(*_port_pair(m, t)) for m, t, _ in
                         [_mk("J0011+01", 99.7, 30, 21)]])
    with pytest.raises(TypeError, match="Mesh"):
        pta_solve(st, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        fit_pta([], mesh=object())
    with pytest.raises(ValueError, match="no axis"):
        pta_solve(st, mesh=cpu_mesh(axis="toa"))


# ---------------------------------------------------------------- GWB


@pytest.fixture(scope="module")
def array3():
    from test_gwb import _mk_pair

    return [_mk_pair("J0001+21", 101.1, 40, 11, "12:01:00.0", "21:00:00.0"),
            _mk_pair("J0430-10", 317.9, 64, 12, "04:30:00.0", "-10:00:00.0"),
            _mk_pair("J1820+55", 218.5, 50, 13, "18:20:00.0", "55:00:00.0")]


def test_sharded_blocks_match_plain(array3):
    """tests/test_gwb.py's three-pulsar array at nfreq 4: the blocks over
    the 8-shard mesh (5 padded slots) against the plain ones, and the
    swept log-likelihood."""
    from test_gwb import _grid

    pairs = [_port_pair(m, t) for t, m in array3]
    plain = GWBLikelihood(pairs=pairs, nfreq=4, device=CPU)
    sharded = GWBLikelihood(problems=plain.problems, nfreq=4,
                            mesh=cpu_mesh())
    assert sharded.device == CPU
    A0, x0, rdr0, ld0 = plain.build_blocks()
    A1, x1, rdr1, ld1 = sharded.build_blocks()
    assert sharded.blocks_info["used_pool"] == "device"
    assert A1.shape == A0.shape == (3, 8, 8)
    np.testing.assert_allclose(A1, A0, rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(x1, x0, rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(rdr1, rdr0, rtol=1e-10)
    np.testing.assert_allclose(ld1, ld0, rtol=1e-10)
    la, ga = _grid()
    np.testing.assert_allclose(sharded.loglik_grid(la, ga),
                               plain.loglik_grid(la, ga), rtol=1e-9)
    with pytest.raises(TypeError, match="Mesh"):
        GWBLikelihood(problems=plain.problems, nfreq=4, mesh=object(),
                      device=CPU)


# -------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def port_zoo():
    from test_serve import _mk as serve_mk

    ref = [serve_mk(0, 50), serve_mk(1, 60), serve_mk(2, 100),
           serve_mk(3, 120)]
    return [_port_pair(m, t)[::-1] for m, t in ref]


def test_mesh_engine_matches_local(port_zoo):
    """tests/test_serve.py's case: an engine splitting the batch axis
    over the 8-shard mesh agrees with the local engine on 4 fit steps,
    and every bucket's batch is a mesh multiple."""
    from pint_tpu_torch.serve import FitStepRequest, ServeEngine

    local = ServeEngine(device=CPU)
    sharded = ServeEngine(mesh=cpu_mesh())
    assert sharded.device == CPU and sharded.cache.mesh is not None
    futs = {}
    for eng in (local, sharded):
        futs[id(eng)] = [eng.submit(FitStepRequest(t, m))
                         for m, t in port_zoo]
        eng.flush()
    for fl, fs in zip(futs[id(local)], futs[id(sharded)]):
        a, b = fl.result(timeout=0), fs.result(timeout=0)
        np.testing.assert_allclose(a.dparams, b.dparams, rtol=1e-9,
                                   atol=1e-18)
        assert a.chi2 == pytest.approx(b.chi2, rel=1e-9)
    assert sharded.metrics.buckets
    assert all(k[-1] % 8 == 0 for k in sharded.metrics.buckets)
    assert not any(k[-1] % 8 == 0 for k in local.metrics.buckets)
    # the engines own their caches: no entry is shared
    assert local.cache is not sharded.cache
    assert sharded.cache.aot is None


def test_gwb_request_on_mesh(array3):
    """GWBRequest.ensure_likelihood threads the engine's mesh into the
    array likelihood; the sweep agrees with the local engine's."""
    from pint_tpu_torch.serve import GWBRequest, ServeEngine

    pairs = [_port_pair(m, t) for t, m in array3]
    la, ga = [-14.5, -14.0], [13 / 3, 4.0]
    out = []
    for kw in ({"device": CPU}, {"mesh": cpu_mesh()}):
        eng = ServeEngine(**kw)
        req = GWBRequest(pairs=pairs, log10A=la, gamma=ga, nfreq=4)
        fut = eng.submit(req)
        eng.flush()
        out.append(np.asarray(fut.result(timeout=0).logL))
        assert (req.likelihood.mesh is None) == ("device" in kw)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-9)


def test_mesh_engine_phase_and_append():
    """The phase and append programs under a mesh: polyco reads bitwise
    the local engine's, an append (cold build, then a rank update)
    within 1e-9 of the local engine's."""
    from pint_tpu_torch.serve import AppendTOAsRequest, \
        PhasePredictRequest, ServeEngine
    from pint_tpu_torch.serve.workload import demo_polyco_entry
    from test_streaming_gls import _mk_append

    rm, rt0, rtn = _mk_append(n0=200, nnew=24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(io.StringIO(rm.as_parfile()), device=CPU)
    t0, tn = toas_from_columns(rt0, CPU), toas_from_columns(rtn, CPU)
    mjds = [55000.0 + np.linspace(-0.01, 0.01, n) for n in (50, 70, 90)]
    out = {}
    for label, kw in (("local", {"device": CPU}), ("mesh",
                                                   {"mesh": cpu_mesh()})):
        eng = ServeEngine(**kw)
        ph = [eng.submit(PhasePredictRequest(demo_polyco_entry(), m))
              for m in mjds]
        cold = eng.submit(AppendTOAsRequest("psr", toas=t0, model=model,
                                            cold=True))
        eng.flush()
        upd = eng.submit(AppendTOAsRequest("psr", toas=tn, model=model))
        eng.flush()
        out[label] = ([f.result(timeout=0) for f in ph],
                      cold.result(timeout=0), upd.result(timeout=0),
                      list(eng.metrics.buckets))
    for a, b in zip(out["local"][0], out["mesh"][0]):
        np.testing.assert_array_equal(a.phase_int, b.phase_int)
        np.testing.assert_array_equal(a.phase_frac, b.phase_frac)
    for a, b in zip(out["local"][1:3], out["mesh"][1:3]):
        assert a.ntoa_total == b.ntoa_total and a.cold == b.cold
        np.testing.assert_allclose(b.dparams, a.dparams, rtol=1e-9,
                                   atol=1e-18)
        assert b.chi2r == pytest.approx(a.chi2r, rel=1e-9)
    assert all(k[-1] % 8 == 0 for k in out["mesh"][3])
