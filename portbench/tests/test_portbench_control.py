"""The comparison that decides ``correct`` fails what it must: the
reference in float32 (the control), and the timed path broken underneath
a whole run."""

import numpy as np
import pytest
import torch

import pint_tpu_torch.gridutils as gridutils
import pint_tpu_torch.pta.gwb as gwb
from portbench import registry, run
from portbench.tests.conftest import small_gwb, small_of

SPEC = registry.load_spec()
CFG = registry.config("ng15-gwb67")
LIMIT = CFG["limits"]["loglik_gap"]


def _run(name, seed, override, mix_override=None, seconds=0.3):
    cell = registry.cell(SPEC, name)
    return run.run_cell(SPEC, cell, seed, seconds, False,
                        torch.device("cpu"), override, mix_override)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 123456789])
def test_float32_control_fails_the_limit(seed):
    """The reference in float32 in the program's place reads a gap over
    the limit, at a size the CPU holds (the readings at the cell's own
    size are in PERF.md)."""
    r = run.execute(registry.cell(SPEC, "ng15-gwb-sweep"), seed, 0.3, False,
                    torch.device("cpu"), small_gwb(8, 5))
    ctrl, no_value = r.system_mod.control(r.system, r.calls, r.ref, r.cfg,
                                          seed, torch.device("cpu"))
    assert ctrl > LIMIT and no_value == 0


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 17, 987654321])
def test_float32_control_fails_at_the_cells_size(seed, card_device):
    r = run.execute(registry.cell(SPEC, "ng15-gwb-sweep"), seed, 3.0, False,
                    card_device)
    prog = r.system_mod.check(r.system, r.calls, r.ref, r.cfg, seed,
                              card_device)["loglik_gap"]
    ctrl, _ = r.system_mod.control(r.system, r.calls, r.ref, r.cfg, seed,
                                   card_device)
    assert prog <= LIMIT < ctrl


def altered(fn):
    """Every log-likelihood the outer stage produces moved by 100 times
    the limit."""
    def wrapped(*a, **k):
        return fn(*a, **k) + 100.0 * LIMIT
    return wrapped


def half_batch(fn):
    """Only the first half of each chunk's points computed; the second
    half given the first half's values."""
    def wrapped(A, x, rdr, ld, G, f, tspan, la, ga):
        h = max(1, (len(la) + 1) // 2)
        out = fn(A, x, rdr, ld, G, f, tspan, la[:h], ga[:h])
        return torch.cat([out, out])[:len(la)]
    return wrapped


@pytest.mark.parametrize("name,fault", [
    ("ng15-gwb-sweep", altered), ("ng15-gwb-sweep", half_batch),
    ("ng15-gwb-sampler", altered)])
def test_broken_timed_path_is_not_correct(name, fault, small, monkeypatch):
    assert _run(name, 41, small)["correct"]
    monkeypatch.setattr(gwb, "_gwb_outer_batch",
                        fault(gwb._gwb_outer_batch))
    out = _run(name, 41, small)
    assert out["correct"] is False
    assert out["compared"]["loglik_gap"]["value"] > LIMIT


def test_half_batch_fault_changes_values(small, monkeypatch):
    """The half-batch fault is no fault for a chunk of one real point (the
    sampler's padding), so it is the sweep's alone: check it moves the
    sweep's values at all."""
    cfg = dict(CFG, **small)
    sysm = registry.module("systems", cfg["system"])
    s = sysm.build(cfg, 8, torch.device("cpu"))
    la = np.linspace(-15, -14, 8)
    ga = np.linspace(3, 5, 8)
    good = s.like.loglik_grid(la, ga)
    monkeypatch.setattr(gwb, "_gwb_outer_batch",
                        half_batch(gwb._gwb_outer_batch))
    bad = s.like.loglik_grid(la, ga)
    assert np.array_equal(good[:4], bad[:4])
    assert np.max(np.abs(good[4:] - bad[4:])) > 1.0


MSP_CFG = registry.config("ng-msp-10k")
MSP_LIMIT = MSP_CFG["limits"]["chi2_gap"]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7, 424242])
def test_msp_float32_control_fails_the_limit(seed):
    """The grid reference in float32 in the program's place reads a gap
    over the limit at a size the CPU holds."""
    r = run.execute(registry.cell(SPEC, "msp10k-chi2grid"), seed, 0.1,
                    False, torch.device("cpu"), *small_of("msp10k-chi2grid"))
    ctrl, _ = r.system_mod.control(r.system, r.calls, r.ref, r.cfg, seed,
                                   torch.device("cpu"))
    assert ctrl > MSP_LIMIT


@pytest.mark.card
@pytest.mark.parametrize("seed", [103, 2 ** 31 + 19, 987654323])
def test_msp_float32_control_fails_at_the_cells_size(seed, card_device):
    r = run.execute(registry.cell(SPEC, "msp10k-chi2grid"), seed, 1.0,
                    False, card_device)
    prog = r.system_mod.check(r.system, r.calls, r.ref, r.cfg, seed,
                              card_device)["chi2_gap"]
    ctrl, _ = r.system_mod.control(r.system, r.calls, r.ref, r.cfg, seed,
                                   card_device)
    assert prog <= MSP_LIMIT < ctrl


def _grid_altered(fn):
    """Every refit chi2 moved by 100 times the limit."""
    def wrapped(*a, **k):
        return fn(*a, **k) + 100.0 * MSP_LIMIT
    return wrapped


def _grid_half_batch(fn):
    """Only the first half of each chunk's nodes refit; the second half
    given the first half's values."""
    from pint_tpu_torch import config

    def wrapped(model, toas, parnames, nodes, maxiter):
        eval_node, nparams = gridutils._build_grid_eval(model, toas,
                                                        parnames, maxiter)
        k = config.grid_chunk(toas.ntoas, nparams)
        t = torch.as_tensor(nodes, dtype=torch.float64, device=model.device)
        batch = torch.func.vmap(eval_node)
        out = []
        for i in range(0, len(t), k):
            c = t[i:i + k]
            v = batch(c[:max(1, (len(c) + 1) // 2)])
            out.append(torch.cat([v, v])[:len(c)])
        return torch.cat(out).cpu().numpy()
    return wrapped


def _step_unchanged(build):
    """A refit step that returns its state unchanged (a zero update)."""
    def wrapped(*a, **k):
        step_fn, args, names = build(*a, **k)

        def step(*sa):
            out = step_fn(*sa)
            return (torch.zeros_like(out[0]),) + tuple(out[1:])
        return step, args, names
    return wrapped


@pytest.mark.parametrize("fault", ["altered", "half_batch", "unchanged"])
def test_broken_grid_is_not_correct(fault, monkeypatch):
    import pint_tpu_torch.parallel.fit_step as fit_step

    name = "msp10k-chi2grid"
    small = small_of(name)
    assert _run(name, 43, *small)["correct"]
    if fault == "unchanged":
        monkeypatch.setattr(fit_step, "build_fit_step",
                            _step_unchanged(fit_step.build_fit_step))
    else:
        wrap = _grid_altered if fault == "altered" else _grid_half_batch
        monkeypatch.setattr(gridutils, "_eval_nodes",
                            wrap(gridutils._eval_nodes))
    out = _run(name, 43, *small)
    assert out["correct"] is False
    assert out["compared"]["chi2_gap"]["value"] > MSP_LIMIT
