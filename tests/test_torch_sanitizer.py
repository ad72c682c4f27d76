"""The port's runtime sanitizer (pint_tpu_torch.analysis.sanitizer) against
the reference's, on the cases of tests/test_sanitizer.py that have a
target in eager torch.

The reference counts jit builds of a model's phase function; the port
counts builds of its per-TOAs device cache (TimingModel.get_cache), the
one thing a model builds from its TOAs. A parameter-value sweep under
``invalidate_cache(params_only=True)`` builds once in both. A structure
change (freezing a parameter) under ``params_only`` retraces the
reference but rebuilds nothing in the port: eager torch has no trace
keyed on the free set, so the port's own count is pinned. Executable
counting (``watch``/``executable_growth``) has no target (eager torch
compiles nothing) and is refused with that reason."""

import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.analysis import Sanitizer as RSanitizer
from pint_tpu.analysis.sanitizer import SanitizerError as RSanitizerError
from pint_tpu.models import get_model as r_get_model
from pint_tpu.residuals import Residuals as RResiduals
from pint_tpu.simulation import make_fake_toas_uniform as r_fake_uniform
from pint_tpu_torch.analysis import Sanitizer
from pint_tpu_torch.analysis.sanitizer import SanitizerError
from pint_tpu_torch.models import get_model
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.simulation import make_fake_toas_uniform

from test_sanitizer import PAR
from test_torch_toa_io import _quiet

CPU = "cpu"


def _problems(n=120):
    """(reference model, TOAs), (port model, TOAs): test_sanitizer.py's
    pulsar simulated by each package from the same generator, each
    model's cache dropped so the first evaluation is build 1."""
    freqs = np.tile([1400.0, 820.0], n // 2)
    rm = _quiet(r_get_model, io.StringIO(PAR))
    rt = _quiet(r_fake_uniform, 54500, 55500, n, rm, error_us=1.0,
                freq_mhz=freqs, add_noise=True,
                rng=np.random.default_rng(7))
    pm = _quiet(get_model, io.StringIO(PAR), device=CPU)
    pt = _quiet(make_fake_toas_uniform, 54500, 55500, n, pm, error_us=1.0,
                freq_mhz=freqs, add_noise=True,
                rng=np.random.default_rng(7))
    rm.invalidate_cache()
    pm.invalidate_cache()
    return (rm, rt), (pm, pt)


def _resid(R, toas, model):
    return _quiet(lambda: R(toas, model).time_resids)


def test_params_only_sweep_compiles_once():
    """A 3-value F0 sweep with params_only invalidation: ONE build in
    both packages, however many evaluations, and the same residuals."""
    (rm, rt), (pm, pt) = _problems()
    with RSanitizer() as rsan, Sanitizer() as san:
        for model, toas, R in ((rm, rt, RResiduals), (pm, pt, Residuals)):
            _resid(R, toas, model)
            for delta in (1e-11, 1e-11, -2e-11):
                model.F0.add_delta(delta)
                model.invalidate_cache(params_only=True)
                last = _resid(R, toas, model)
            if R is Residuals:
                got = last.numpy()
            else:
                want = np.asarray(last)
    assert rsan.compiles("phase") == 1, rsan.builds
    assert san.compiles("phase") == san.compiles() == 1, san.builds
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_structure_change_bumps_compile_count():
    """Freezing F1 under params_only: the reference retraces (2 builds),
    the port keeps its cache (1: nothing is keyed on the free set); a
    full invalidate_cache() rebuilds in both (3 and 2)."""
    (rm, rt), (pm, pt) = _problems()
    with RSanitizer() as rsan, Sanitizer() as san:
        for model, toas, R in ((rm, rt, RResiduals), (pm, pt, Residuals)):
            _resid(R, toas, model)
            model.F1.frozen = True
            model.invalidate_cache(params_only=True)
            _resid(R, toas, model)
        assert rsan.compiles("phase") == 2, rsan.builds
        assert san.compiles("phase") == 1, san.builds
        for model, toas, R in ((rm, rt, RResiduals), (pm, pt, Residuals)):
            model.invalidate_cache()
            _resid(R, toas, model)
    assert rsan.compiles("phase") == 3, rsan.builds
    assert san.compiles("phase") == 2, san.builds


def test_production_fit_step_builds_once_and_watch_is_refused():
    """The production fit step built once and run at three parameter
    vectors builds the model's cache once; the reference's executable
    count (watch/executable_growth) has no target in eager torch and
    raises NotImplementedError naming why."""
    from pint_tpu_torch.parallel import build_fit_step

    _, (pm, pt) = _problems()
    with Sanitizer() as san:
        step, args, _ = build_fit_step(pm, pt)
        out0 = step(*args)
        for delta in (1e-11, 2e-11, -3e-11):
            pm.F0.add_delta(delta)
            pm.invalidate_cache(params_only=True)
            _, _, th, tl, _, _ = pm._pack()
            out = step(torch.as_tensor(th), torch.as_tensor(tl), *args[2:])
    assert san.compiles("phase") == 1, san.builds
    assert torch.isfinite(out[2]) and not torch.equal(out[0], out0[0])
    with pytest.raises(NotImplementedError, match="eager torch"):
        san.watch(step, "fit_step")
    with pytest.raises(NotImplementedError, match="executable"):
        san.executable_growth()


def test_wrap_flags_host_operands_and_nans():
    """A numpy operand entering a wrapped dispatch is recorded the same
    way in both packages (a device tensor is not), and a non-finite
    output raises."""
    rsan, san = RSanitizer(nan_check=True), Sanitizer(nan_check=True)
    for s, dev_array, host_err in (
            (rsan, jnp.ones(3), RSanitizerError),
            (san, torch.ones(3, dtype=torch.float64), SanitizerError)):
        guarded = s.wrap(lambda x: x * 2.0, "d")
        guarded(dev_array)
        assert not s.host_crossings
        s.assert_no_host_crossings()
        guarded(np.ones(3))
        assert s.host_crossings == [("d", 1)]
        with pytest.raises(host_err):
            s.assert_no_host_crossings()

    def nan_out():
        return torch.ones(2), {"x": torch.tensor([np.nan])}

    with pytest.raises(SanitizerError, match="nanfn"):
        san.wrap(nan_out, "nanfn")()
    rbad = rsan.wrap(lambda: jnp.array([np.nan]), "nanfn")
    with pytest.raises(RSanitizerError):
        rbad()
    # nan_check per wrap: off here, so the same output passes
    assert san.wrap(nan_out, "quiet", nan_check=False)()[1]["x"].isnan()


def test_wrap_walks_nested_and_opaque_operands():
    """The operand scan descends nested dicts/tuples/lists and plain
    objects (request/entry dataclasses) in both packages, with the same
    counts; device arrays, scalars and strings never count."""
    from pint_tpu_torch.ops.dd import DD

    rsan, san = RSanitizer(), Sanitizer()
    cases = [
        (lambda d: (({"M": np.ones(3), "aux": (np.ones(2), d(2))},),
                    {"extra": [np.ones(1)]}), 3),
        (lambda d: ((types.SimpleNamespace(
            mjds=np.ones(4), entry=types.SimpleNamespace(
                coeffs=np.ones(5), f0=1.0)),), {}), 2),
        (lambda d: ((np.ones((2, 2)).view(np.matrix),), {}), 1),
        (lambda d: ((d(3), 1.0, "label"), {"flag": True}), 0),
    ]
    for build, n in cases:
        for s, d in ((rsan, jnp.ones),
                     (san, lambda k: torch.ones(k, dtype=torch.float64))):
            s.reset()
            a, kw = build(d)
            s.wrap(lambda *a, **k: 0, "nested")(*a, **kw)
            assert s.host_crossings == ([("nested", n)] if n else [])
    san.reset()
    san.wrap(lambda *a: 0, "dd")(DD(torch.ones(2), torch.zeros(2)),
                                 (np.zeros(2), np.zeros(2)))
    assert san.host_crossings == [("dd", 2)]


@pytest.fixture
def port_recompile_guard():
    """The port's counterpart of conftest's recompile_guard: a Sanitizer
    wired around the test body."""
    with Sanitizer() as san:
        yield san


def test_recompile_guard_fixture(port_recompile_guard, recompile_guard):
    (rm, rt), (pm, pt) = _problems(60)
    recompile_guard.reset()
    port_recompile_guard.reset()
    for model, toas, R in ((rm, rt, RResiduals), (pm, pt, Residuals)):
        _resid(R, toas, model)
        model.DM.add_delta(1e-6)
        model.invalidate_cache(params_only=True)
        _resid(R, toas, model)
    assert recompile_guard.compiles("phase") == 1
    assert port_recompile_guard.compiles("phase") == 1
