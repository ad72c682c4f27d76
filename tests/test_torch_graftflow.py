"""graftflow's G9 for the port (pint_tpu_torch.analysis.graftflow): the
G9 cases of tests/test_graftflow.py rewritten in torch's spellings
(``.to(torch.float32)``, ``.float()``, ``dtype=torch.float32``,
``"float32"``), positive and negative, the registry's hygiene, the CFG
engine, ``verify_probes`` and ``predict_profile`` against the
reference's, and the differential validation of tests/test_dtype_probe.py
over the same route grid: ``Sanitizer.dtype_probe`` on a built step
observes what ``predict_profile`` predicts. The port's own tree lints
clean with G9 on (tests/test_torch_graftlint.py::test_repo_clean)."""

import ast
import io
import textwrap
import warnings

import numpy as np
import pytest

from pint_tpu.analysis import graftflow as rgf

from pint_tpu_torch.analysis import Sanitizer
from pint_tpu_torch.analysis import cfg as fcfg
from pint_tpu_torch.analysis import graftflow as gf
from pint_tpu_torch.analysis import graftlint as gl
from pint_tpu_torch.analysis import precision_registry as reg

pytestmark = pytest.mark.lint

FIX = "pint_tpu_torch/models/_fixture.py"


def _flow(src, relpath=FIX, registry=None, verify_probes=False):
    """Run the graftflow checks on one snippet module."""
    m = gl.ModuleInfo(relpath, textwrap.dedent(src))
    return gf.run_flow_checks([m], registry=[] if registry is None
                              else registry,
                              verify_probe_sites=verify_probes)


def _rules(violations):
    return sorted({v.rule for v in violations})


# ------------------------------------------------------------------ G9

def test_g9_flags_demotion_outside_registry():
    v, _ = _flow("""
        import torch
        def step(pv, batch, cache):
            return batch.t.to(torch.float32)
    """)
    assert "G9" in _rules(v)
    assert "precision_registry" in v[0].msg


def test_g9_flags_every_torch_spelling():
    """.to(torch.float32), .to(dtype=...), .float(), .type(...), dtype=
    constructions, the "float32" string and numpy's astype/float32."""
    v, _ = _flow("""
        import numpy as np
        import torch
        def step(pv, batch, cache):
            a = batch.t.to(torch.float32)
            b = batch.t.to(dtype=torch.float32)
            c = batch.t.float()
            d = batch.t.type(torch.float32)
            e = torch.zeros(3, dtype=torch.float32)
            f = torch.as_tensor(cache, dtype="float32")
            g = np.asarray(cache).astype("float32")
            h = np.float32(0.5)
            i = np.zeros(3, np.float32)
            return a, b, c, d, e, f, g, h, i
    """)
    assert [x.rule for x in v].count("G9") == 9


def test_g9_ignores_float64_and_host_spellings():
    """Float64 casts, the builtin float(), a dtype read from a variable
    and a comparison with torch.float32 are not demotions."""
    v, _ = _flow("""
        import torch
        def step(pv, batch, cache, dt):
            a = batch.t.to(torch.float64)
            b = batch.t.double()
            c = float(cache)
            d = batch.t.to(dt)
            e = batch.t.dtype == torch.float32
            return a, b, c, d, e
    """)
    assert not v


def test_g9_registered_boundary_is_sanctioned_and_stale_fails():
    rg = [dict(file=FIX, func="step", flag="jac32", guard="jac32",
               why="fixture boundary")]
    v, sup = _flow("""
        import torch
        def step(pv, batch, cache, jac32=False):
            if jac32:
                return batch.t.to(torch.float32)
            return batch.t
    """, registry=rg)
    assert "G9" not in _rules(v)
    assert any("fixture boundary" in why for _, why in sup)
    v2, _ = _flow("def host():\n    return 1\n", registry=rg)
    assert [x.rule for x in v2] == ["REGISTRY"]


def test_g9_guard_claim_must_match_the_code():
    rg = [dict(file=FIX, func="step", flag="jac32", guard="jac32",
               why="fixture")]
    v, _ = _flow("""
        import torch
        def step(pv, batch, cache):
            return batch.t.float()
    """, registry=rg)
    assert "G9" in _rules(v)
    assert "drifted" in v[0].msg


def test_g9_guard_check_rejects_the_else_branch():
    rg = [dict(file=FIX, func="step", flag="jac32", guard="jac32",
               why="fixture")]
    wrong, _ = _flow("""
        import torch
        def step(pv, batch, cache):
            jac32 = bool(cache)
            if jac32:
                y = batch.t
            else:
                y = batch.t.to(torch.float32)
            return y
    """, registry=rg)
    assert any("drifted" in x.msg for x in wrong)
    inverted, sup = _flow("""
        import torch
        def step(pv, batch, cache):
            jac32 = bool(cache)
            if not jac32:
                y = batch.t
            else:
                y = batch.t.to(torch.float32)
            return y
    """, registry=rg)
    assert not any(x.rule == "G9" for x in inverted) and sup


def test_g9_dd_consumer_rejects_f32_provenance_in_protected_module():
    v, _ = _flow("""
        import torch
        from pint_tpu_torch.ops.dd import DD, dd_add
        def _kernel(pv, r):
            r32 = r.to(torch.float32)
            return dd_add(DD(r32, r32), pv["X"])
    """, relpath="pint_tpu_torch/gls.py")
    assert any("dd consumer" in x.msg for x in v if x.rule == "G9")


def test_g9_dd_consumer_clean_on_f64_and_outside_protected_set():
    clean = _flow("""
        from pint_tpu_torch.ops.dd import DD, dd_add
        def _kernel(pv, r):
            return dd_add(DD(r, r), pv["X"])
    """, relpath="pint_tpu_torch/gls.py")[0]
    assert not [x for x in clean if "dd consumer" in x.msg]
    outside = _flow("""
        import torch
        from pint_tpu_torch.ops.dd import DD, dd_add
        def _kernel(pv, r):
            r32 = r.float()
            return dd_add(DD(r32, r32), pv["X"])
    """, relpath="pint_tpu_torch/gridutils.py")[0]
    assert not [x for x in outside if "dd consumer" in x.msg]
    assert [x.rule for x in outside] == ["G9"]   # the demotion itself


def test_g9_taint_survives_branches_and_upcasts():
    v, _ = _flow("""
        import torch
        from pint_tpu_torch.ops.dd import DD, dd_add
        def _kernel(pv, r, fast):
            x = r
            if fast:
                x = r.to(torch.float32)
            y = x.to(torch.float64)
            return dd_add(DD(y, y), pv["X"])
    """, relpath="pint_tpu_torch/gls.py")
    assert any("dd consumer" in x.msg for x in v)


def test_g9_taint_survives_method_call_hops():
    v, _ = _flow("""
        import torch
        from pint_tpu_torch.ops.dd import DD, dd_add
        def _kernel(pv, r):
            x = r.float()
            y = x.reshape(-1)
            return dd_add(DD(y, y), pv["X"])
    """, relpath="pint_tpu_torch/gls.py")
    assert any("dd consumer" in x.msg for x in v)


def test_g9_flags_mixed_known_dtype_arithmetic():
    v, _ = _flow("""
        import torch
        def step(pv, batch):
            a = batch.t.to(torch.float32)
            b = batch.t.double()
            return a * b
    """)
    assert any("mixed float32 x float64" in x.msg for x in v)


def test_g9_reads_host_functions_but_not_the_linter():
    """No trace boundary in eager torch: a demotion in a plain host
    function is a site too; the linter's own modules are not read."""
    v, _ = _flow("""
        import numpy as np
        def helper(x):
            return np.asarray(x, dtype=np.float32)
    """)
    assert [x.rule for x in v] == ["G9"]
    assert not _flow("""
        def f(node):
            return mentions(node, "float32", dtype="float32")
    """, relpath="pint_tpu_torch/analysis/_fixture.py")[0]


def test_demotion_kind_names_the_spelling():
    def kind(src):
        return gf.demotion_kind(ast.parse(src).body[0].value)

    assert kind("x.to(torch.float32)") == "to(float32)"
    assert kind("x.float()") == ".float()"
    assert kind("dd_to_dd32(a)") == "dd_to_dd32()"
    assert kind("torch.ones(2, dtype=torch.float32)") == \
        "dtype=float32 construction"
    assert kind("np.float32(1.0)") == "float32(...) literal"
    assert kind("x.to(torch.float64)") is None
    assert kind("float(x)") is None


# ------------------------------------------------ registry and probes

def test_registry_entries_are_justified_and_live():
    """Every entry carries a reason and a route flag expression that
    evaluates; on the real tree none is stale (test_repo_clean runs the
    same pass)."""
    flags = dict(jac32=True, f32mm=False, anchored=True, hybrid=False)
    for e in reg.DEMOTIONS:
        assert len(e["why"]) > 40, e
        assert e["file"].startswith("pint_tpu_torch/")
        if e["flag"] is not None:
            gf._eval_flag(e["flag"], flags)
    report = gl.run_lint(gl.find_repo_root(gl.__file__), dynamic=False)
    assert not [v for v in report.violations
                if v.rule in ("G9", "REGISTRY")]
    g9 = [v for v, _ in report.suppressed if v.rule == "G9"]
    assert len(g9) == sum(e.get("max_hits", 1) for e in reg.DEMOTIONS)


def test_probe_table_verification_detects_lost_sites():
    m = gl.ModuleInfo("pint_tpu_torch/parallel/fit_step.py",
                      "def f():\n    return 1\n")
    v = gf.verify_probes([m])
    assert v and all(x.rule == "REGISTRY" for x in v)


def test_predict_profile_matches_registry_flags():
    p = gf.predict_profile(jac32=True, f32mm=False, anchored=False,
                           hybrid=True)
    assert p["dd32_split"]["active"] and \
        p["dd32_split"]["dtype"] == "float32"
    assert p["symm_mm"]["dtype"] == "float32"
    assert not p["symm_mm_f32"]["active"]
    assert p["phase_frac"]["active"]
    p64 = gf.predict_profile()
    assert p64["symm_mm"]["dtype"] == "float64"
    assert not p64["dd32_split"]["active"]


@pytest.mark.parametrize("flags", [
    dict(), dict(jac32=True, hybrid=True), dict(f32mm=True),
    dict(jac32=True, f32mm=True, anchored=True, hybrid=True),
    dict(anchored=True)], ids=lambda f: "-".join(f) or "f64")
def test_predict_profile_equals_the_reference(flags):
    """The port's probe table predicts what the reference's does."""
    assert gf.predict_profile(**flags) == rgf.predict_profile(**flags)


# ------------------------------------------------------ cfg engine

def test_cfg_joins_branches_and_loops():
    fn = ast.parse(textwrap.dedent("""
        def f(cond, n):
            x = "a"
            if cond:
                x = "b"
            for i in range(n):
                y = x
            return x
    """)).body[0]
    graph = fcfg.build_cfg(fn)

    def transfer(st, env, is_header):
        if isinstance(st, ast.Assign) and \
                isinstance(st.targets[0], ast.Name):
            v = st.value
            if isinstance(v, ast.Constant):
                env[st.targets[0].id] = {v.value}
            elif isinstance(v, ast.Name):
                env[st.targets[0].id] = set(env.get(v.id, set()))

    def join(a, b):
        return set(a) | set(b)

    in_envs = fcfg.run_dataflow(graph, {}, transfer, join)
    exit_env = in_envs[graph.exit.bid]
    assert exit_env["x"] == {"a", "b"}
    assert exit_env.get("y", set()) <= {"a", "b"}


# ------------------------------- differential validation (dtype probe)

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


@pytest.fixture(scope="module")
def problem():
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model(io.StringIO(BASE), device="cpu")
        rng = np.random.default_rng(3)
        mjds = np.sort(rng.uniform(54001, 55999, 60))
        toas = make_fake_toas_fromMJDs(
            mjds, model, error_us=1.0,
            freq_mhz=np.tile([1400.0, 820.0], 30), add_noise=True,
            rng=rng)
    return model, toas


# tests/test_dtype_probe.py's grid: the all-float64 step, the reference's
# TPU production stack, and the two mixed ones that pin the coupling
CONFIGS = [
    dict(anchored=False, jac_f32=False, matmul_f32=False,
         hybrid_jac=False),
    dict(anchored=True, jac_f32=True, matmul_f32=True, hybrid_jac=True),
    dict(anchored=False, jac_f32=True, matmul_f32=False, hybrid_jac=True),
    dict(anchored=True, jac_f32=False, matmul_f32=True, hybrid_jac=False),
    dict(anchored=False, jac_f32=False, matmul_f32=True, hybrid_jac=True),
]


@pytest.mark.parametrize("flags", CONFIGS, ids=lambda f: "-".join(
    k for k, v in f.items() if v) or "f64")
def test_static_predictions_match_observed_dtypes(problem, flags):
    from pint_tpu_torch.parallel import build_fit_step

    model, toas = problem
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step_fn, args, _ = build_fit_step(model, toas, device="cpu",
                                          **flags)
    san = Sanitizer()
    with san.dtype_probe():
        step_fn(*args)
    observed = san.observed_profile()
    hybrid_active = bool(flags["hybrid_jac"]) and \
        bool(model.linear_design_names())
    predicted = gf.predict_profile(
        jac32=flags["jac_f32"], f32mm=flags["matmul_f32"],
        anchored=flags["anchored"], hybrid=hybrid_active)
    assert predicted
    for label, pred in predicted.items():
        obs = observed.get(label)
        assert (obs is not None) == pred["active"], (label, flags)
        if pred["active"]:
            assert pred["dtype"] in obs["dtypes"], (label, obs, flags)
    assert set(observed) <= set(predicted)


def test_probe_records_only_device_tensors(problem):
    """The host build (the anchor's numpy dd32 splits) records nothing:
    with no step run inside the context, nothing is recorded although
    the build splits numpy pairs."""
    from pint_tpu_torch.parallel import build_fit_step

    model, toas = problem
    san = Sanitizer()
    with san.dtype_probe():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step, args, _ = build_fit_step(model, toas, device="cpu",
                                           anchored=True, jac_f32=True)
    assert san.dtype_records == []
    # the patches are undone on exit
    with san.dtype_probe():
        pass
    step(*args)
    assert san.dtype_records == []
