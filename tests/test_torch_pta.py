"""The pulsar-array batch fit of the port (pint_tpu_torch.parallel.pta)
against the reference pint_tpu on the CPU, on tests/test_pta.py's trio
(three heterogeneous pulsars, one with EFAC/ECORR on clustered TOAs).

Tolerances: the joint normal system within 1e-10 of each matrix's
largest entry; the batch solve within 1e-8 relative (atol 1e-15) of the
reference's compiled solve and of its numpy mirror — tests/test_pta.py's
limits; the numpy mirror copied bitwise. ``build_problem`` is held to the
reference run eagerly (``jax.disable_jit()``: compiled, XLA rounds some
delays 1 ulp away from the eager chain, ~5e-14 s) at 1e-10 of each
column's largest entry. The batched ``gls`` helpers are held bitwise to a
loop of unbatched calls."""

import io
import warnings

import jax
import numpy as np
import pytest
import torch

from pint_tpu.parallel import build_problem as r_build_problem
from pint_tpu.parallel import pta_solve as r_pta_solve
from pint_tpu.parallel import stack_problems as r_stack_problems
from pint_tpu.parallel.pta import _assemble_normal as r_assemble_normal
from pint_tpu.parallel.pta import pta_solve_np as r_pta_solve_np
from pint_tpu.pta.shard import pad_batch as r_pad_batch

from pint_tpu_torch.gls import cho_factor, cho_solve, jacobi
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_problem, fit_pta, pta_solve, \
    stack_problems
from pint_tpu_torch.parallel.pta import STACK_KEYS, _assemble_normal, \
    pta_solve_np
from pint_tpu_torch.pta import pad_batch

from test_pta import _mk

CPU = "cpu"
RTOL, ATOL = 1e-8, 1e-15


def _port_model(m):
    """The port's model of a reference model: its par text."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_model(io.StringIO(m.as_parfile()), device=CPU)


@pytest.fixture(scope="module")
def trio():
    """tests/test_pta.py's trio (reference models and TOAs)."""
    return [_mk("J0001+01", 101.1, 40, 1, perturb=1e-10),
            _mk("J0002+02", 317.9, 64, 2, perturb=-2e-10),
            _mk("J0003+03", 218.5, 50, 3, perturb=1.5e-10,
                noise_lines="EFAC -be X 1.2\nECORR -be X 1.0\n",
                clustered=True)]


@pytest.fixture(scope="module")
def ref_problems(trio):
    return [r_build_problem(t, m) for m, t, _ in trio]


@pytest.fixture(scope="module")
def ref_stacked(ref_problems):
    return r_stack_problems(ref_problems)


def _torch(stacked):
    return [torch.as_tensor(stacked[k]) for k in STACK_KEYS]


def _within(got, want, tol, axis):
    """|got - want| <= tol * the largest |want| along ``axis``."""
    scale = np.max(np.abs(want), axis=axis, keepdims=True)
    err = np.max(np.abs(got - want) / np.where(scale == 0, 1.0, scale))
    assert err <= tol, err


def test_build_problem_matches_eager_reference(trio):
    for m, t, _ in trio:
        with jax.disable_jit():
            ref = r_build_problem(t, m)
        got = build_problem(toas_from_columns(t, CPU), _port_model(m))
        assert got.names == ref.names
        for k in ("M", "r", "nvec", "F", "phi"):
            a, b = getattr(got, k), getattr(ref, k)
            assert a.shape == b.shape, k
            if b.size:
                _within(a, b, 1e-10, axis=0)


def test_stack_problems_is_the_reference_copy(trio, ref_stacked):
    problems = [build_problem(toas_from_columns(t, CPU), _port_model(m))
                for m, t, _ in trio]
    st = stack_problems(problems, shape=(4, 70, 7, 30))
    ref = r_stack_problems(problems, shape=(4, 70, 7, 30))
    for k in STACK_KEYS:
        np.testing.assert_array_equal(st[k], ref[k])
    assert st["valid"].sum() == 40 + 64 + 50
    with pytest.raises(ValueError):
        stack_problems(problems, shape=(2, 64, 6, 25))


def test_assemble_normal_matches_reference(ref_stacked):
    got = _assemble_normal(*_torch(ref_stacked))
    want = jax.vmap(r_assemble_normal)(
        *(ref_stacked[k] for k in STACK_KEYS))
    for g, w in zip(got, want):
        w = np.asarray(w)
        _within(g.numpy(), w, 1e-10, axis=tuple(range(1, w.ndim)))


@pytest.mark.parametrize("padded", [False, True])
def test_batch_solve_matches_reference(ref_problems, padded):
    """Also on a batch padded with ``shape=``: one more slot (fully
    padded) and wider N, p and q."""
    st = r_stack_problems(ref_problems,
                          shape=(4, 67, 7, 27) if padded else None)
    got = pta_solve(st, device=CPU)
    ref = [np.asarray(o) for o in r_pta_solve(st)]
    mirror = r_pta_solve_np(st)
    for g, r, n in zip(got, ref, mirror):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, n, rtol=RTOL, atol=ATOL)
    # the fully padded slot is the identity system
    if padded:
        dparams, cov, chi2, chi2r = got
        np.testing.assert_array_equal(dparams[-1], 0.0)
        assert chi2[-1] == 0.0 and chi2r[-1] == 0.0
        np.testing.assert_array_equal(np.diag(cov[-1]), 1.0)


def test_pta_solve_np_is_the_reference_copy(ref_stacked):
    for g, r in zip(pta_solve_np(ref_stacked), r_pta_solve_np(ref_stacked)):
        np.testing.assert_array_equal(g, r)


def test_non_pd_slot_gives_nan_only_there(ref_stacked):
    """A tiny negative noise prior makes slot 2's normal matrix
    indefinite: its results are NaN, the other slots' those of the intact
    batch."""
    st = {k: np.array(v) for k, v in ref_stacked.items()}
    st["phi"][2] = -1e-30
    bad = pta_solve(st, device=CPU)
    ref = pta_solve(ref_stacked, device=CPU)
    for b, r in zip(bad, ref):
        assert np.isnan(b[2]).all()
        np.testing.assert_array_equal(b[:2], r[:2])


def test_fit_pta_recovers(trio):
    pairs = [(toas_from_columns(t, CPU), _port_model(m)) for m, t, _ in trio]
    res = fit_pta(pairs, maxiter=3, device=CPU)
    assert len(res) == 3
    for (t, m), (_, _, truth), r in zip(pairs, trio, res):
        assert r["chi2"] > 0
        for k, v in truth.items():
            err = r["errors"][k]
            assert abs(m.get_param(k).value - v) < 5 * err, (m.name, k)
            assert m.get_param(k).uncertainty == err
    st = res.stats
    assert st is fit_pta.last_stats
    assert st["npulsars"] == 3 and st["ntoa_total"] == 154
    assert st["iterations"] == 4
    assert 0 < st["device_solve_s"] < st["wall_time_s"]
    assert 0 < st["build_problem_s"] < st["wall_time_s"]


def _spd_batch(n=6, P=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(P, n, n))
    A = X @ np.swapaxes(X, 1, 2) + n * np.eye(n)
    A[2] = -A[2]                               # slot 2 is not PD
    return torch.as_tensor(A), torch.as_tensor(rng.normal(size=(P, n))), \
        torch.as_tensor(rng.normal(size=(P, n, 3)))


def test_gls_helpers_batch_safe():
    """jacobi, cho_factor and cho_solve on a (P, n, n) batch equal a loop
    of unbatched calls bitwise; the non-PD slot is NaN and only it."""
    A, b, B = _spd_batch()
    d = jacobi(A)
    L = cho_factor(A / (d[:, :, None] * d[:, None, :]))
    x = cho_solve(L, b)
    X = cho_solve(L, B)
    for k in range(A.shape[0]):
        dk = jacobi(A[k])
        Lk = cho_factor(A[k] / torch.outer(dk, dk))
        assert torch.equal(d[k], dk)
        if k == 2:
            for t in (Lk, L[k], x[k], X[k]):
                assert torch.isnan(t).all()
            continue
        assert not torch.isnan(L[k]).any()
        assert torch.equal(L[k], Lk)
        assert torch.equal(x[k], cho_solve(Lk, b[k]))
        assert torch.equal(X[k], cho_solve(Lk, B[k]))


def test_refusals_name_item_11(ref_stacked, trio):
    with pytest.raises(NotImplementedError, match="item 11"):
        pta_solve(ref_stacked, device=CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        fit_pta([], mesh=object())


def test_default_device_is_the_gpu(ref_stacked):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pta_solve(ref_stacked)


class _Mesh:
    shape = {"pulsar": 4}


def test_pad_batch_matches_reference(ref_stacked):
    got = pad_batch(ref_stacked, _Mesh(), "pulsar")
    ref = r_pad_batch(ref_stacked, _Mesh(), "pulsar")
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["M"].shape[0] == 4
    copy = pad_batch(ref_stacked, None)
    assert copy == ref_stacked and copy is not ref_stacked
