"""The port's linter (pint_tpu_torch.analysis.graftlint) — a seeded
positive and a clean negative per ported rule, pragmas and the
allowlist, the repo-clean gate over pint_tpu_torch/ and chip_smoke.py,
and the reference oracle:

- for every rule whose meaning is unchanged (G3, G4, G5, G6(a), G8,
  G12, G13, G14, G16, G17), both linters run on the same synthetic
  sources, placed under each package's path, and return the same
  (rule, line) set;
- for a re-meant rule (G1/G2, G6(b), G7, G15), a torch fixture flags
  the same lines as the reference's jax fixture of the same shape.

Run standalone with ``pytest -m lint tests/test_torch_graftlint.py``."""

import json
import os
import textwrap

import pytest

from pint_tpu.analysis import concurrency as rconc
from pint_tpu.analysis import graftlint as rgl
from pint_tpu_torch.analysis import concurrency as conc
from pint_tpu_torch.analysis import graftlint as gl

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pint_tpu_torch"


def _module(lint, relpath, src):
    """A ModuleInfo of ``lint`` (either package's graftlint) with its
    compute/jit regions marked."""
    m = lint.ModuleInfo(relpath, textwrap.dedent(src))
    if lint is gl:
        gl.mark_compute_regions(
            m, gl.collect_compute_seed_names([m])[relpath])
    else:
        rgl.mark_jit_regions(m, rgl.collect_jit_seed_names([m])[relpath])
    return m


def _lint_py(src, relpath=f"{PKG}/models/_fixture.py"):
    """The port's per-module AST rules (and the class-graph rules) on
    one snippet."""
    m = _module(gl, relpath, src)
    progs, private = gl.collect_device_programs([m])
    out = gl.check_g1(m) + gl.check_g2(m) + gl.check_g6_python(m)
    out += gl.check_g6_dispatch(m, progs[relpath] | private)
    out += gl.check_g7(m) + gl.check_g8(m) + gl.check_g12(m)
    out += gl.check_g13(m) + gl.check_g14(m) + gl.check_g15(m)
    out += conc.check_g16(m, {}) + conc.check_g17(m)
    graph = gl.ClassGraph([m])
    out += gl.check_g3(graph) + gl.check_g4_static(graph)
    out += gl.check_g5_static(graph)
    return out


def _rules(violations):
    return sorted({v.rule for v in violations})


def _lines(violations, rule):
    return sorted(v.line for v in violations if v.rule == rule)


# ---------------------------------------------------------------- rules


def test_rules_list_the_ported_rules_only():
    assert set(gl.RULES) == {"G1", "G2", "G3", "G4", "G5", "G6", "G7",
                             "G8", "G9", "G12", "G13", "G14", "G15",
                             "G16", "G17"}
    assert set(gl.RULES) < set(rgl.RULES)
    doc = gl.__doc__
    for rid in ("G10", "G11"):
        assert rid not in gl.RULES and f"{rid} (" in doc
    for rid in gl.RULES:
        assert rid in doc


def test_g1_flags_host_syncs_in_pv_compute_paths():
    v = _lint_py("""
        class Thing(Component):
            def delay(self, pv, batch, cache, ctx, delay_so_far):
                a = float(pv["DM"].hi)
                b = pv["F0"].hi.item()
                c = pv["F1"].hi.cpu()
                return self.helper(a, b, c)

            def helper(self, *x):
                return x[0].tolist()
    """)
    assert _lines(v, "G1") == [4, 5, 6, 10]


def test_g1_flags_syncs_in_transformed_functions():
    v = _lint_py("""
        import torch

        def build():
            def fn(x):
                return x.numpy()
            return torch.func.vmap(fn)
    """, relpath=f"{PKG}/parallel/_fixture.py")
    assert _lines(v, "G1") == [6]


def test_g1_clean_on_host_code_and_host_attrs():
    v = _lint_py("""
        class Thing(Component):
            def delay(self, pv, batch, cache, ctx, delay_so_far):
                n = int(self.DM.value) + len(batch)
                f = float(frozen_value(self, "F0"))
                return pv["DM"].hi * n * f

            def host(self, toas):
                return float(toas.x.cpu().numpy().sum())
    """)
    assert "G1" not in _rules(v)


def test_g2_flags_numpy_in_models_compute_path_only():
    src = """
        import numpy as np

        class Thing(Component):
            def delay(self, pv, batch, cache, ctx, delay_so_far):
                return np.sum(pv["DM"].hi)

            def host(self, toas):
                return np.sum(toas.x)
    """
    assert _lines(_lint_py(src), "G2") == [6]
    assert "G2" not in _rules(_lint_py(
        src, relpath=f"{PKG}/parallel/_fixture.py"))


def test_g3_flags_missing_citation_and_accepts_one():
    v = _lint_py('''
        class PhaseComponent(Component):
            """abstract"""

        class Bare(PhaseComponent):
            """Spin phase."""

        class Cited(PhaseComponent):
            """Spin phase (reference: src/pint/models/spindown.py)."""

        class _Private(PhaseComponent):
            """Helper."""
    ''')
    assert [x.msg.split()[1] for x in v if x.rule == "G3"] == ["Bare"]


def test_g4_static_flags_missing_spec_and_accepts_inherited():
    v = _lint_py('''
        class DelayComponent(Component):
            """abstract"""

        class NoSpec(DelayComponent):
            """x (reference: y)."""
            def __init__(self):
                self.add_param(floatParameter("A"))

        class Base(DelayComponent):
            """x (reference: y)."""
            def param_dimensions(self):
                return {}

        class Child(Base):
            """x (reference: y)."""
            def __init__(self):
                self.add_param(floatParameter("B"))
    ''')
    assert [x.msg.split()[1] for x in v if x.rule == "G4"] == ["NoSpec"]


def test_g4_dynamic_flags_uncovered_param_and_accepts_covered():
    from pint_tpu_torch.models.parameter import floatParameter
    from pint_tpu_torch.models.timing_model import DelayComponent

    class Uncovered(DelayComponent):
        register = False

        def __init__(self):
            super().__init__()
            self.add_param(floatParameter("ZZTOP", units="s"))

    class Covered(Uncovered):
        register = False

        def param_dimensions(self):
            from pint_tpu_torch.units import parse_unit

            return {"ZZTOP": parse_unit("s")}

    v = gl.check_g4_dynamic({"Uncovered": Uncovered})
    assert _rules(v) == ["G4"] and "ZZTOP" in v[0].msg
    assert gl.check_g4_dynamic({"Covered": Covered}) == []


def test_g5_static_flags_unpaired_hooks():
    v = _lint_py('''
        class PhaseComponent(Component):
            """abstract"""

        class Half(PhaseComponent):
            """x (reference: y)."""
            def linear_design_names(self):
                return []

        class Whole(PhaseComponent):
            """x (reference: y)."""
            def linear_design_names(self):
                return []
            def linear_design_local(self, pv, batch, cache, ctx):
                return {}
    ''')
    assert [x.msg.split()[1] for x in v if x.rule == "G5"] == ["Half"]


def test_g5_dynamic_flags_component_absent_from_sink():
    import types

    class Claimer:
        def linear_design_names(self):
            return ["F0"]

    model = types.SimpleNamespace(free_params=["F0"], components={})
    v = gl.check_g5_dynamic({"Claimer": Claimer}, model)
    assert _rules(v) == ["G5"] and "SINK_PAR" in v[0].msg
    model.components = {"Claimer": Claimer()}
    assert gl.check_g5_dynamic({"Claimer": Claimer}, model) == []


def test_dynamic_registry_checks_are_clean_on_the_port():
    """The import-the-zoo half over the port's registry and
    tests/test_all_components.py's SINK_PAR (built on the CPU)."""
    assert gl.dynamic_registry_checks(REPO) == []


def test_g6_flags_unbounded_subprocesses_in_scripts_and_smoke():
    src = """
        import subprocess
        from subprocess import Popen, run as r

        def go():
            subprocess.run(["x"])
            subprocess.run(["x"], timeout=5)
            r(["y"])
            Popen(["z"])
    """
    for rel in (f"{PKG}/scripts/_fixture.py", "chip_smoke.py"):
        assert _lines(_lint_py(src, relpath=rel), "G6") == [6, 8, 9]
    assert "G6" not in _rules(_lint_py(src, relpath=f"{PKG}/toa.py"))


def test_g6_flags_direct_call_of_a_device_program():
    v = _lint_py("""
        from pint_tpu_torch.runtime import get_supervisor

        def fit(x):
            def run(y):
                return y * 2
            with obs.span("fit"):
                out = get_supervisor().dispatch(run, x, key="k")
            return out + run(x)

        def again(self, sup, x):
            with obs.span("again"):
                return sup.dispatch(self._kernel, x) + self._kernel(x)
    """, relpath=f"{PKG}/gls.py")
    assert _lines(v, "G6") == [9, 13]


def test_g6_device_programs_clean_through_the_supervisor():
    src = """
        def fit(sup, x):
            def run(y):
                return y * 2
            with obs.span("fit"):
                return sup.dispatch(run, x, key="k")
    """
    assert _rules(_lint_py(src, relpath=f"{PKG}/serve/_f.py")) == []
    # outside the dispatch layer, and in runtime/ (the supervisor)
    direct = src + """
        def direct(x):
            return run(x)
    """
    assert _lines(_lint_py(direct, relpath=f"{PKG}/serve/_f.py"),
                  "G6") == [9]
    for rel in (f"{PKG}/bayesian.py", f"{PKG}/runtime/_f.py"):
        assert "G6" not in _rules(_lint_py(direct, relpath=rel))


def test_g7_flags_global_torch_switches_outside_entry_points():
    src = """
        import torch
        from torch import set_default_dtype

        torch.set_default_dtype(torch.float32)
        set_default_dtype(torch.float64)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("high")
        torch.use_deterministic_algorithms(True)
        torch.set_default_device("cuda")
        x = torch.ones(3, dtype=torch.float64)
    """
    assert _lines(_lint_py(src, relpath=f"{PKG}/gls.py"), "G7") == \
        [5, 6, 7, 8, 9, 10, 11]
    for rel in (f"{PKG}/__init__.py", f"{PKG}/config.py",
                f"{PKG}/analysis/graftlint.py"):
        assert "G7" not in _rules(_lint_py(src, relpath=rel))


def test_g8_flags_lru_cache_on_methods_only():
    v = _lint_py("""
        import functools
        from functools import lru_cache

        class K:
            @functools.lru_cache(maxsize=None)
            def a(self, x):
                return x

            @lru_cache
            def b(self):
                return 1

        @functools.lru_cache
        def module_level(x):
            return x
    """)
    assert _lines(v, "G8") == [7, 11]


def test_g12_flags_naked_dispatch_and_clean_under_span():
    v = _lint_py("""
        def naked(sup, fn):
            return sup.dispatch(fn, key="k")

        def covered(sup, fn):
            with obs.span("x"):
                return sup.dispatch(fn, key="k")

        def root(sup, fn):
            with obs.attach(ctx):
                return helper(sup, fn)

        def helper(sup, fn):
            return sup.dispatch_async(fn, key="k")

        def other(engine, fn):
            return engine.dispatch(fn)
    """, relpath=f"{PKG}/serve/_fixture.py")
    assert _lines(v, "G12") == [3]


def test_g13_flags_counter_increments_in_the_dispatch_layer():
    src = """
        def bump(self, d):
            self.failovers += 1
            d["shed_quota"] += 1
            self.n_count = self.n_count + 1
            self.total = 0
            local_count = 0
            local_count += 1
            self._c["completed"].inc()
    """
    assert _lines(_lint_py(src, relpath=f"{PKG}/serve/_f.py"), "G13") == \
        [3, 4, 5]
    assert "G13" not in _rules(_lint_py(src, relpath=f"{PKG}/obs/_f.py"))


def test_g14_flags_stray_health_metric_and_unobserved_vector():
    v = _lint_py("""
        def mint(om):
            return om.counter("pint_tpu_health_custom_total", "x")

        def reads(out):
            hv = out[4]
            return float(hv[0])

        def observes(out, mon):
            hv = out[4]
            mon.observe("k", {"hv": hv})
    """, relpath=f"{PKG}/serve/_fixture.py")
    assert _lines(v, "G14") == [3, 5]
    assert _lint_py('om.counter("pint_tpu_health_x_total", "y")\n',
                    relpath=f"{PKG}/obs/health.py") == []


def test_g15_flags_profiler_and_flop_probes_outside_perf_plane():
    src = """
        import torch
        from torch.profiler import profile
        from torch.utils.flop_counter import FlopCounterMode

        def go(fn):
            with torch.profiler.profile() as p:
                fn()
            with profile():
                fn()
            torch.cuda.profiler.start()
            with FlopCounterMode(display=False):
                fn()
            with torch.profiler.record_function("ok"):
                fn()
    """
    assert _lines(_lint_py(src, relpath=f"{PKG}/serve/_f.py"), "G15") == \
        [7, 9, 11, 12]
    for rel in (f"{PKG}/obs/perf.py", f"{PKG}/profiling.py"):
        assert "G15" not in _rules(_lint_py(src, relpath=rel))


def test_g16_flags_raw_primitives_and_accepts_factories():
    v = _lint_py("""
        import threading
        from threading import RLock
        from pint_tpu_torch.runtime import locks

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._rl = RLock()
                self._cv = threading.Condition(self._lock)
                self._ok = locks.make_lock("serve.x")
                self._okc = locks.make_condition(self._ok)
    """, relpath=f"{PKG}/serve/_fixture.py")
    assert _lines(v, "G16") == [8, 9, 10]
    assert "G16" not in _rules(_lint_py(
        "import threading\nL = threading.Lock()\n",
        relpath=f"{PKG}/pintk/_fixture.py"))


def test_g16_guarded_writes_blocking_calls_and_stale_entries():
    from pint_tpu_torch.analysis import lock_registry as reg

    hits = {}
    m = gl.ModuleInfo(f"{PKG}/serve/scheduler.py", textwrap.dedent("""
        class ServeEngine:
            def __init__(self):
                self._nqueued = 0

            def submit(self, req, sup, fn):
                self._nqueued += 1
                with self._cv:
                    self._open[req] = 1
                    sup.dispatch(fn, key="x")

            def _seal_locked(self):
                self._nqueued -= 1
    """))
    v = conc.check_g16(m, hits)
    assert _lines(v, "G16") == [7, 10]
    assert sum(hits.values()) == 4
    stale = conc.g16_stale_entries(hits)
    assert len(stale) == len(reg.GUARDED) - 2
    assert all(x.scope == "repo" and "stale" in x.msg for x in stale)


def test_g16_scrape_root_reaching_engine_lock_flags():
    sched = gl.ModuleInfo(f"{PKG}/serve/scheduler.py", textwrap.dedent("""
        class ServeEngine:
            def snapshot_all(self):
                with self._lock:
                    return dict(self._open)
    """))
    bad = gl.ModuleInfo(f"{PKG}/obs/metrics.py", textwrap.dedent("""
        from pint_tpu_torch.serve import scheduler

        def do_GET(self):
            return scheduler.snapshot_all(self.eng)

        def default_health():
            return {}
    """))
    v = conc.check_g16_scrape_paths([sched, bad])
    reach = [x for x in v if "reaches engine-lock" in x.msg]
    assert len(reach) == 1 and "do_GET" in reach[0].msg
    assert [x for x in conc.check_g16_scrape_paths([]) if "stale"
            not in x.msg] == []


def test_lock_registry_has_the_reference_entries():
    """The port's registry: the reference's 21 entries (17 guarded
    fields, 1 engine-lock set, 3 scrape roots) on the port's paths."""
    from pint_tpu.analysis import lock_registry as rreg
    from pint_tpu_torch.analysis import lock_registry as reg

    assert reg.entry_count() == rreg.entry_count() == 21
    strip = [(e["file"].split("/", 1)[1], e["cls"], e["field"],
              e["lock"], tuple(e.get("aliases", ())),
              tuple(e["holders"])) for e in reg.GUARDED]
    rstrip = [(e["file"].split("/", 1)[1], e["cls"], e["field"],
               e["lock"], tuple(e.get("aliases", ())),
               tuple(e["holders"])) for e in rreg.GUARDED]
    assert strip == rstrip
    assert all(e["file"].startswith(f"{PKG}/") and e["why"]
               for e in reg.GUARDED + reg.ENGINE_LOCKS + reg.SCRAPE_ROOTS)
    assert reg.BLOCKING_CALLS == rreg.BLOCKING_CALLS


def test_g17_flags_raw_env_reads_outside_config():
    src = """
        import os
        from os import environ, getenv

        a = os.environ.get("PINT_TPU_X")
        b = environ["PINT_TPU_Y"]
        c = getenv("PINT_TPU_Z")
        d = os.getenv("HOME")
    """
    assert _lines(_lint_py(src, relpath=f"{PKG}/ops/_f.py"), "G17") == \
        [5, 6, 7, 8]
    assert "G17" not in _rules(_lint_py(src, relpath=f"{PKG}/config.py"))


# ------------------------------------------------- pragmas, allowlist


def test_pragma_suppresses_only_the_matching_rule():
    rel = f"{PKG}/serve/_fixture.py"
    src = ("import os\n"
           "a = os.environ.get('X')  # graftlint: allow G17 -- fixture\n"
           "b = os.environ.get('Y')  # graftlint: allow G16 -- wrong rule\n")
    report = gl.LintReport(violations=conc.check_g17(
        gl.ModuleInfo(rel, src)))
    gl.apply_suppressions(report, [], {rel: src})
    assert [v.line for v in report.violations] == [3]
    assert len(report.suppressed) == 1
    assert report.suppressed[0][1] == "pragma: fixture"


def test_allowlist_suppresses_up_to_max_hits_and_stale_entries_fail():
    rel = f"{PKG}/serve/_fixture.py"
    src = "import os\na = os.environ['X']\nb = os.environ['X']\n"
    entry = dict(rule="G17", file=rel, match="os.environ['X']",
                 why="fixture")

    def run(entries):
        report = gl.LintReport(violations=conc.check_g17(
            gl.ModuleInfo(rel, src)))
        gl.apply_suppressions(report, entries, {rel: src})
        return report

    r1 = run([entry])
    assert [v.line for v in r1.violations] == [3]
    r2 = run([dict(entry, max_hits=2)])
    assert r2.violations == [] and len(r2.suppressed) == 2
    stale = dict(rule="G17", file=rel, match="nothing", why="stale")
    r3 = run([dict(entry, max_hits=2), stale])
    assert [v.rule for v in r3.violations] == ["ALLOWLIST"]
    assert r3.violations[0].scope == "repo"


def test_allowlist_entries_carry_reasons():
    from pint_tpu_torch.analysis.allowlist import ALLOWLIST

    for e in ALLOWLIST:
        assert e["rule"] in gl.RULES and len(e["why"]) > 40, e
        assert os.path.exists(os.path.join(REPO, e["file"])), e


def test_repo_clean(capsys):
    """The port's tree lints clean, the dynamic half included, through
    the CLI's JSON wire format; every suppression is a written pragma
    or allowlist entry."""
    rc = gl.main(["--root", REPO, "--format", "json"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0, lines
    summary = lines[-1]
    assert summary["clean"] and summary["violations"] == 0
    assert summary["rules"] == len(gl.RULES) == 15
    assert summary["files_scanned"] > 100
    report = gl.run_lint(REPO, dynamic=False)
    assert report.clean, [v.format() for v in report.violations]
    for v, why in report.suppressed:
        assert why.split(": ", 1)[1].strip(), v.format()


def test_github_annotation_wire_format():
    v = gl.Violation("G17", f"{PKG}/x.py", 0, "a%b\nc")
    assert gl.github_annotation(v) == (
        f"::error file={PKG}/x.py,line=1,title=graftlint G17::"
        "G17: a%25b%0Ac")


def test_lint_state_labels_the_tree(monkeypatch):
    import pint_tpu_torch.analysis as an

    st = an.lint_state()
    assert st["clean"] and st["violations"] == 0 and st["static_only"]
    assert st["rules"] == len(gl.RULES)

    def broken():
        raise RuntimeError("analyzer down")

    monkeypatch.setattr(an, "lint_state", broken)
    assert an.lint_state_safe() == {
        "clean": None, "error": "RuntimeError('analyzer down')"}


# ----------------------------------------------------- reference oracle


def _both_lines(src, rel, checks):
    """{(rule, line)} of ``checks(lint, conc, module)`` on ``src`` placed
    at ``rel`` under each package."""
    out = []
    for lint, cmod, pkg in ((rgl, rconc, "pint_tpu"), (gl, conc, PKG)):
        m = _module(lint, f"{pkg}/{rel}", src)
        out.append({(v.rule, v.line) for v in checks(lint, cmod, m)})
    return out


_CLASS_SRC = '''
    class DelayComponent(Component):
        """abstract"""

    class NoCite(DelayComponent):
        """Undocumented."""
        def __init__(self):
            self.add_param(floatParameter("A"))

    class Base(DelayComponent):
        """x (reference: src/pint/models/base.py Base)."""
        def param_dimensions(self):
            return {}

    class Half(Base):
        """x (reference: y)."""
        def __init__(self):
            self.add_param(MJDParameter("B"))
        def linear_design_names(self):
            return []

    class _Hidden(DelayComponent):
        """no citation, private"""

    class Off(DelayComponent):
        """no citation"""
        register = False
'''

_G8_SRC = '''
    import functools
    from functools import lru_cache, cache

    class K:
        @functools.lru_cache(maxsize=None)
        def a(self, x):
            return x

        @lru_cache
        def b(self):
            return 1

        @cache
        def c(cls):
            return 2

        @staticmethod
        @functools.lru_cache
        def d(x):
            return x

    @functools.lru_cache
    def module_level(x):
        return x
'''

_DISPATCH_SRC = '''
    def naked(sup, fn):
        return sup.dispatch(fn, key="k")

    def covered(sup, fn):
        with obs.span("x"):
            return sup.dispatch(fn, key="k")

    def root(self, fn):
        with obs.attach(ctx):
            return self.helper(fn)

    def helper(self, fn):
        return self.supervisor.dispatch_async(fn, key="k")

    def outer(sup, fn):
        with obs.span("o"):
            def inner():
                return get_supervisor().dispatch(fn, key="k")
            return inner()

    def orphan_async(fn):
        return get_supervisor().dispatch_async(fn, key="k")

    def bumps(self, d, out):
        self.failovers += 1
        d["shed_quota"] += 1
        d["rows"] = d.get("rows", 0) + len(out)
        self.timeouts = self.timeouts + 1
        self.fresh_total = 5 + 1
        tally = 0
        tally += 1

    def stray(om):
        return om.gauge("pint_tpu_health_stray", "x")

    def reads(out):
        hv = out[6]
        return float(hv[1])

    def observed(out, mon):
        hv_pass = out[6]
        mon.observe("k", {"hv": hv_pass})

    def builder(out, mon):
        def closure():
            return out["hv"]
        mon.observe("k", closure())

    def producer(pv, batch, hv):
        return hv + 1

    import os
    from os import environ

    key = os.environ.get("PINT_TPU_K")
    raw = environ["PINT_TPU_R"]
    home = os.getenv("HOME")
'''

_SCHED_SRC = '''
    import threading
    from threading import Lock

    class ServeEngine:
        def __init__(self):
            self._lock = make_rlock("x")
            self._nqueued = 0
            self._open = {}

        def submit(self, req, sup, fn):
            self._nqueued += 1
            self._open.pop(req, None)
            with self._cv:
                self._ready.append(req)
                self._journal.admit(req)
            with self._lock:
                sup.dispatch(fn, key="x")

        def _expire_locked(self):
            self._earliest_expiry = 0.0

        def stop(self):
            self._drain_stop_at = 1.0

        def _dispatch_finish(self):
            self._pool_last_collect = 2.0

        def drain(self, sup, fn):
            with self._dispatch_lock:
                self._dead = True
                sup.dispatch(fn, key="y")
            self._dead = False

        def raw(self):
            self.a = threading.Lock()
            self.b = Lock()
            self.c = threading.Condition(self.a)
'''


def test_oracle_component_rules_g3_g4_g5():
    def checks(lint, cmod, m):
        g = lint.ClassGraph([m])
        return lint.check_g3(g) + lint.check_g4_static(g) + \
            lint.check_g5_static(g)

    want, got = _both_lines(_CLASS_SRC, "models/_fixture.py", checks)
    assert got == want and {r for r, _ in got} == {"G3", "G4", "G5"}


def test_oracle_g8():
    want, got = _both_lines(_G8_SRC, "serve/_fixture.py",
                            lambda lint, cmod, m: lint.check_g8(m))
    assert got == want == {("G8", 7), ("G8", 11), ("G8", 15)}


@pytest.mark.parametrize("rule", ["G12", "G13", "G14", "G17"])
def test_oracle_dispatch_layer_rules(rule):
    fn = {"G12": lambda lint, cmod, m: lint.check_g12(m),
          "G13": lambda lint, cmod, m: lint.check_g13(m),
          "G14": lambda lint, cmod, m: lint.check_g14(m),
          "G17": lambda lint, cmod, m: cmod.check_g17(m)}[rule]
    for rel in ("serve/_fixture.py", "parallel/_fixture.py",
                "obs/_fixture.py", "pintk/_fixture.py"):
        want, got = _both_lines(_DISPATCH_SRC, rel, fn)
        assert got == want, (rel, got ^ want)
    want, got = _both_lines(_DISPATCH_SRC, "serve/_fixture.py", fn)
    assert got and all(r == rule for r, _ in got)


def test_oracle_g16_registry_discipline():
    def checks(lint, cmod, m):
        return cmod.check_g16(m, {})

    for rel in ("serve/scheduler.py", "serve/_fixture.py",
                "runtime/_fixture.py", "toa.py"):
        want, got = _both_lines(_SCHED_SRC, rel, checks)
        assert got == want, (rel, got ^ want)
    want, got = _both_lines(_SCHED_SRC, "serve/scheduler.py", checks)
    assert len(got) >= 7


def test_oracle_g16_scrape_paths():
    srcs = {
        "serve/scheduler.py": '''
            class ServeEngine:
                def snapshot_all(self):
                    with self._cv:
                        return dict(self._open)
                def quiet(self):
                    return 1
        ''',
        "obs/metrics.py": '''
            from {pkg}.serve import scheduler

            def _collect(eng):
                return scheduler.snapshot_all(eng)

            def do_GET(self):
                return _collect(self.eng)

            def default_health():
                return {{}}
        ''',
        "serve/admission.py": '''
            class AdmissionController:
                def snapshot(self):
                    return self.quiet()
                def quiet(self):
                    return {{}}
        '''}
    sets = []
    for lint, cmod, pkg in ((rgl, rconc, "pint_tpu"), (gl, conc, PKG)):
        mods = [lint.ModuleInfo(f"{pkg}/{rel}", textwrap.dedent(
            src if rel == "serve/scheduler.py" else src.format(pkg=pkg)))
            for rel, src in srcs.items()]
        sets.append({(v.rule, v.line, v.path.split("/", 1)[1])
                     for v in cmod.check_g16_scrape_paths(mods)})
    assert sets[1] == sets[0] and len(sets[1]) == 1


def test_oracle_g6_subprocess_bounds():
    src = '''
        import subprocess
        from subprocess import Popen, check_output as co

        def go():
            subprocess.run(["a"])
            subprocess.call(["b"], timeout=3)
            co(["c"])
            Popen(["d"])
            subprocess.Popen(["e"])
    '''
    want = {("G6", 6), ("G6", 8), ("G6", 9), ("G6", 10)}
    for rel_ref, rel_port in (("tools/_f.py", "chip_smoke.py"),
                              ("pint_tpu/scripts/_f.py",
                               f"{PKG}/scripts/_f.py")):
        r = {(v.rule, v.line) for v in rgl.check_g6_python(
            _module(rgl, rel_ref, src))}
        p = {(v.rule, v.line) for v in gl.check_g6_python(
            _module(gl, rel_port, src))}
        assert p == r == want


# --------------------------------------- re-meant rules: paired fixtures


def _pair_lines(jax_src, torch_src, rel, rule, ref_checks, port_checks):
    r = {(v.rule, v.line) for v in ref_checks(
        _module(rgl, f"pint_tpu/{rel}", jax_src)) if v.rule == rule}
    p = {(v.rule, v.line) for v in port_checks(
        _module(gl, f"{PKG}/{rel}", torch_src)) if v.rule == rule}
    return r, p


def test_remeant_g1_g2_host_syncs():
    jax_src = '''
        import jax
        import numpy as np

        class Thing(Component):
            def delay(self, pv, batch, cache, ctx, delay_so_far):
                a = float(pv["DM"].hi)
                b = pv["F0"].hi.item()
                c = np.sum(batch.freq_mhz)
                n = int(self.DM.value) + len(batch)
                return self.helper(a, b, c, n)

            def helper(self, *x):
                return x[0].tolist()

            def host(self, toas):
                return float(toas.x)

        def build():
            def fn(x):
                return float(x)
            return jax.jit(jax.vmap(fn))
    '''
    torch_src = '''
        import torch
        import numpy as np

        class Thing(Component):
            def delay(self, pv, batch, cache, ctx, delay_so_far):
                a = float(pv["DM"].hi)
                b = pv["F0"].hi.cpu()
                c = np.sum(batch.freq_mhz)
                n = int(self.DM.value) + len(batch)
                return self.helper(a, b, c, n)

            def helper(self, *x):
                return x[0].tolist()

            def host(self, toas):
                return float(toas.x)

        def build():
            def fn(x):
                return float(x)
            return torch.func.vmap(torch.func.jacfwd(fn))
    '''
    for rule, rchk, pchk in (("G1", rgl.check_g1, gl.check_g1),
                             ("G2", rgl.check_g2, gl.check_g2)):
        r, p = _pair_lines(jax_src, torch_src, "models/_f.py", rule, rchk,
                           pchk)
        assert p == r and p, rule
    assert {ln for _, ln in p} == {9}


def test_remeant_g6_device_programs():
    jax_src = '''
        import jax

        def solve(sup, x):
            kernel = jax.jit(f)
            with obs.span("s"):
                out = sup.dispatch(kernel, x, key="k")
            return out + kernel(x)

        def twice(self, x):
            return self._fit(x) + 1
    '''
    torch_src = '''
        import torch

        def solve(sup, x):
            kernel = make_program(f)
            with obs.span("s"):
                out = sup.dispatch(kernel, x, key="k")
            return out + kernel(x)

        def twice(self, x):
            return self._fit(x) + 1
    '''

    def rchk(m):
        prods, private = rgl.collect_jit_products([m])
        return rgl.check_g6_dispatch(m, prods[m.relpath] | private)

    def pchk(m):
        progs, private = gl.collect_device_programs([m])
        return gl.check_g6_dispatch(m, progs[m.relpath] | private)

    r, p = _pair_lines(jax_src, torch_src, "serve/_f.py", "G6", rchk, pchk)
    assert p == r == {("G6", 8)}


def test_remeant_g7_global_switches():
    jax_src = '''
        import jax
        from jax import config

        jax.config.update("jax_enable_x64", True)
        config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "high")
        x = jax.numpy.ones(3)
    '''
    torch_src = '''
        import torch
        from torch import set_default_dtype

        torch.set_default_dtype(torch.float64)
        set_default_dtype(torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = True
        x = torch.ones(3)
    '''
    for rel in ("gls.py", "serve/_f.py", "config.py", "__init__.py"):
        r, p = _pair_lines(jax_src, torch_src, rel, "G7", rgl.check_g7,
                           gl.check_g7)
        assert p == r, rel
    assert p == set() and r == set()
    r, p = _pair_lines(jax_src, torch_src, "gls.py", "G7", rgl.check_g7,
                       gl.check_g7)
    assert p == {("G7", 5), ("G7", 6), ("G7", 7)}


def test_remeant_g15_profiler_and_cost_probes():
    jax_src = '''
        import jax
        import jax.numpy as jnp

        def go(fn, x):
            jax.profiler.start_trace("/tmp/t")
            fn(x)
            jax.profiler.stop_trace()
            compiled = jax.jit(fn).lower(x).compile()
            return compiled.cost_analysis()
    '''
    torch_src = '''
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        def go(fn, x):
            prof = torch.profiler.profile()
            fn(x)
            torch.cuda.profiler.stop()
            mode = FlopCounterMode(display=False)
            return torch.autograd.profiler.profile()
    '''
    for rel in ("serve/_f.py", "obs/perf.py", "profiling.py"):
        r, p = _pair_lines(jax_src, torch_src, rel, "G15", rgl.check_g15,
                           gl.check_g15)
        assert p == r, rel
    r, p = _pair_lines(jax_src, torch_src, "serve/_f.py", "G15",
                       rgl.check_g15, gl.check_g15)
    assert p == {("G15", 6), ("G15", 8), ("G15", 9), ("G15", 10)}
