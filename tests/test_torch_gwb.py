"""The Hellings–Downs GWB likelihood of the port (pint_tpu_torch.pta)
against the reference pint_tpu on the CPU: tests/test_gwb.py's oracles
(the HD matrix, the Gamma = I limit against the per-pulsar sum, the dense
brute-force joint covariance) run through the port's torch path, then the
torch blocks and sweep against the reference's compiled
``_gwb_block_batch``/``_gwb_outer_batch`` and its numpy mirror on the
same stacked inputs (tests/test_gwb.py's three-pulsar array, nfreq 4).

Tolerances: tests/test_gwb.py's own (Gamma = I 1e-10, dense oracle 1e-9,
device against mirror 1e-9); blocks and log L within 1e-9 relative of the
reference and its mirror; the numpy copies and the HD geometry bitwise or
at 1e-12; chunked sweeps within 1e-12 of each other."""

import io
import warnings

import jax
import numpy as np
import pytest
import torch

from pint_tpu import config as r_config
from pint_tpu.parallel.pta import _solve_one_np
from pint_tpu.pta import GWBLikelihood as RGWBLikelihood
from pint_tpu.pta import hd_matrix as r_hd_matrix
from pint_tpu.pta import pulsar_positions as r_pulsar_positions
from pint_tpu.pta.gwb import _gwb_block_batch as r_block_batch
from pint_tpu.pta.gwb import _gwb_outer_batch as r_outer_batch
from pint_tpu.pta.gwb import gwb_loglik_np as r_gwb_loglik_np

from pint_tpu_torch import config
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel.pta import STACK_KEYS, PulsarProblem, \
    stack_problems
from pint_tpu_torch.pta import GWBLikelihood, PTAMetrics, gwb_phi, \
    hd_matrix, pulsar_positions
from pint_tpu_torch.pta.gwb import _gwb_block_batch, _gwb_outer_batch, \
    _gwb_outer_np, _outer_system, gwb_blocks_np, gwb_loglik_np

from test_gwb import _grid, _mk_pair, _synthetic_problems

CPU = "cpu"
RTOL = 1e-9


def _port_pairs(array):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [(toas_from_columns(t, CPU),
                 get_model(io.StringIO(m.as_parfile()), device=CPU))
                for t, m in array]


@pytest.fixture(scope="module")
def array3():
    """tests/test_gwb.py's three pulsars (reference TOAs and models)."""
    return [_mk_pair("J0001+21", 101.1, 40, 11,
                     "12:01:00.0", "21:00:00.0"),
            _mk_pair("J0430-10", 317.9, 64, 12,
                     "04:30:00.0", "-10:00:00.0"),
            _mk_pair("J1820+55", 218.5, 50, 13,
                     "18:20:00.0", "55:00:00.0")]


@pytest.fixture(scope="module")
def ref_like(array3):
    return RGWBLikelihood(pairs=array3, nfreq=4)


@pytest.fixture(scope="module")
def like3(array3):
    return GWBLikelihood(pairs=_port_pairs(array3), nfreq=4, device=CPU)


def _torch_loglik(stacked, U, Gamma, fcols, tspan, la, ga):
    """The port's two torch stages end to end on the CPU."""
    A, x, rdr, ld = _gwb_block_batch(
        *(torch.as_tensor(stacked[k]) for k in STACK_KEYS),
        torch.as_tensor(U))
    return _gwb_outer_batch(
        A, x, float(rdr.sum()), float(ld.sum()), torch.as_tensor(Gamma),
        torch.as_tensor(fcols), float(tspan), torch.as_tensor(la),
        torch.as_tensor(ga)).numpy()


# -- geometry ----------------------------------------------------------

def test_hd_matrix_is_the_reference_copy():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(20, 3))
    pos /= np.linalg.norm(pos, axis=1)[:, None]
    np.testing.assert_array_equal(hd_matrix(pos), r_hd_matrix(pos))
    assert np.all(np.linalg.eigvalsh(hd_matrix(pos)) > 0)
    g = hd_matrix(np.array([[1.0, 0, 0], [0, 1.0, 0]]))
    np.testing.assert_allclose(g[0, 1], 0.75 * np.log(0.5) + 0.375,
                               rtol=1e-12)


def test_pulsar_positions_match_reference(array3, like3):
    got = pulsar_positions([pr.model for pr in like3.problems])
    want = r_pulsar_positions([m for _, m in array3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(like3.Gamma, r_hd_matrix(want), rtol=0,
                               atol=1e-12)


# -- algebraic oracles through the torch path --------------------------

def test_gamma_eye_reduces_to_per_pulsar_sum():
    """tests/test_gwb.py:145's oracle: at Gamma = I the two-stage Schur
    likelihood is the sum of per-pulsar marginal likelihoods with the
    GWB basis appended as ordinary red noise."""
    from scipy.linalg import cho_factor

    rng = np.random.default_rng(1)
    tspan = 3.0e8
    probs, Us, st, Ust, fcols = _synthetic_problems(rng, 4, 3, tspan)
    la, ga = -14.3, 4.33
    phi_g = gwb_phi(fcols, tspan, la, ga)
    tot = 0.0
    for k, pr in enumerate(probs):
        n, p = pr.M.shape
        Faug = np.concatenate([pr.F, Us[k]], axis=1)
        phiaug = np.concatenate([pr.phi, phi_g])
        _, _, chi2, _ = _solve_one_np(pr.M, Faug, phiaug, pr.r, pr.nvec,
                                      np.ones(n), np.ones(p))
        w = 1.0 / pr.nvec
        colmax = np.max(np.abs(pr.M), axis=0)
        Ms = pr.M / colmax[None, :]
        norm = np.sqrt(np.sum(Ms * Ms * w[:, None], axis=0))
        big = np.concatenate([Ms / norm[None, :], Faug], axis=1)
        Sigma = big.T @ (big * w[:, None]) + np.diag(
            np.concatenate([np.zeros(p), 1.0 / phiaug]))
        cf = cho_factor(Sigma, lower=True)
        ld = (np.sum(np.log(pr.nvec)) + np.sum(np.log(phiaug)) +
              2 * np.sum(np.log(np.diagonal(cf[0]))) +
              2 * np.sum(np.log(colmax * norm)))
        tot += -0.5 * (chi2 + ld)
    got = _torch_loglik(st, Ust, np.eye(4), fcols, tspan,
                        np.array([la]), np.array([ga]))[0]
    np.testing.assert_allclose(got, tot, rtol=1e-10)
    np.testing.assert_allclose(
        gwb_loglik_np(st, Ust, np.eye(4), fcols, tspan, np.array([la]),
                      np.array([ga]))[0], tot, rtol=1e-10)


def test_dense_brute_force_hd_oracle():
    """tests/test_gwb.py:186's oracle: with no timing-model columns the
    blocked Woodbury with a real HD Gamma equals slogdet + solve on the
    dense (sum n)^2 joint covariance."""
    rng = np.random.default_rng(2)
    tspan = 2.0e8
    P, nfreq = 3, 2
    probs, Us, st, Ust, fcols = _synthetic_problems(
        rng, P, nfreq, tspan, p=0)
    ns = [pr.M.shape[0] for pr in probs]
    pos = rng.normal(size=(P, 3))
    pos /= np.linalg.norm(pos, axis=1)[:, None]
    G = hd_matrix(pos)
    la, ga = -14.0, 13.0 / 3.0
    phi_g = gwb_phi(fcols, tspan, la, ga)
    C = np.zeros((sum(ns), sum(ns)))
    off = np.cumsum([0] + ns)
    for a in range(P):
        sa = slice(off[a], off[a + 1])
        C[sa, sa] += np.diag(probs[a].nvec) + \
            probs[a].F @ np.diag(probs[a].phi) @ probs[a].F.T
        for b in range(P):
            sb = slice(off[b], off[b + 1])
            C[sa, sb] += G[a, b] * (Us[a] @ np.diag(phi_g) @ Us[b].T)
    rfull = np.concatenate([pr.r for pr in probs])
    _, ld = np.linalg.slogdet(C)
    dense = -0.5 * (rfull @ np.linalg.solve(C, rfull) + ld)
    got = _torch_loglik(st, Ust, G, fcols, tspan, np.array([la]),
                        np.array([ga]))[0]
    np.testing.assert_allclose(got, dense, rtol=1e-9)


def test_outer_system_block_add_matches_numpy():
    """The strided-view block add equals np.kron plus the per-pulsar
    S4[a, :, a, :] += A[a] loop, bitwise."""
    rng = np.random.default_rng(3)
    P, m, K = 3, 4, 2
    A = rng.normal(size=(P, m, m))
    Ginv = rng.normal(size=(P, P))
    phi = 10.0 ** rng.uniform(-14, -12, size=(K, m))
    got = _outer_system(torch.as_tensor(A), torch.as_tensor(Ginv),
                        torch.as_tensor(phi)).numpy()
    for k in range(K):
        S4 = np.kron(Ginv, np.diag(1.0 / phi[k])).reshape(P, m, P, m)
        for a in range(P):
            S4[a, :, a, :] += A[a]
        np.testing.assert_array_equal(got[k], S4.reshape(P * m, P * m))


# -- the torch stages against the reference's --------------------------

def test_blocks_match_reference_and_mirror(ref_like):
    st, U = ref_like.stacked, ref_like.U
    got = _gwb_block_batch(*(torch.as_tensor(st[k]) for k in STACK_KEYS),
                           torch.as_tensor(U))
    ref = jax.jit(r_block_batch)(*(st[k] for k in STACK_KEYS), U)
    mirror = gwb_blocks_np(st, U)
    for g, r, n in zip(got, ref, mirror):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(r)))
        np.testing.assert_allclose(g.numpy(), n, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(n)))


def test_sweep_matches_reference_and_mirror(ref_like):
    A, x, rdr_sum, ld_sum = ref_like.build_blocks()
    la, ga = _grid()
    args = (A, x, rdr_sum, ld_sum, ref_like.Gamma, ref_like.fcols,
            ref_like.tspan)
    got = _gwb_outer_batch(
        *(torch.as_tensor(a) for a in (A, x)), rdr_sum, ld_sum,
        *(torch.as_tensor(a) for a in (ref_like.Gamma, ref_like.fcols)),
        ref_like.tspan, torch.as_tensor(la), torch.as_tensor(ga)).numpy()
    ref = np.asarray(jax.jit(r_outer_batch)(*args, la, ga))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got, _gwb_outer_np(*args, la, ga),
                               rtol=RTOL)
    assert np.ptp(got) > 1.0


def test_likelihood_matches_reference(ref_like, like3):
    """The whole likelihood from the port's own problems: its basis and
    Gamma match the reference's, log L within 1e-9 relative."""
    np.testing.assert_array_equal(like3.U, ref_like.U)
    np.testing.assert_array_equal(like3.fcols, ref_like.fcols)
    assert like3.tspan == ref_like.tspan
    la, ga = _grid()
    got = like3.loglik_grid(la, ga)
    assert like3.blocks_info["used_pool"] == "device"
    np.testing.assert_allclose(got, ref_like.loglik_grid(la, ga),
                               rtol=RTOL)
    np.testing.assert_allclose(
        got, r_gwb_loglik_np(like3.stacked, like3.U, like3.Gamma,
                             like3.fcols, like3.tspan, la, ga), rtol=RTOL)


def test_host_pool_and_single_point(like3):
    la, ga = np.array([-14.0]), np.array([13.0 / 3.0])
    info = {}
    host = like3.loglik_grid(la, ga, pool="host", info=info)
    assert info["used_pool"] == "host"
    dev = like3.loglik_grid(la, ga)
    np.testing.assert_allclose(host, dev, rtol=RTOL)
    np.testing.assert_allclose(like3.loglik(-14.0, 13.0 / 3.0), dev[0],
                               rtol=1e-12)


def test_grid_progress_and_chunking(like3):
    la, ga = _grid()          # 36 points
    seen = []
    got = like3.loglik_grid(la, ga, chunk=8, progress=seen.append)
    assert seen == [8, 16, 24, 32, 36]
    np.testing.assert_allclose(got, like3.loglik_grid(la, ga, chunk=16),
                               rtol=1e-12)
    seen2 = []
    collect = like3.loglik_grid(la, ga, chunk=8, sync=False,
                                progress=seen2.append)
    assert seen2 == []        # chunk 0 enqueued, nothing read yet
    np.testing.assert_array_equal(collect(), got)
    assert seen2 == seen
    assert like3.loglik_grid([], []).shape == (0,)


def test_likelihood_counts_its_work(array3):
    lk = GWBLikelihood(pairs=_port_pairs(array3), nfreq=2, device=CPU)
    la = np.linspace(-14.5, -14.0, 5)
    ga = np.full(5, 4.0)
    lk.loglik_grid(la, ga, chunk=2)
    assert lk.metrics.snapshot() == {
        "gwb_solves": 3, "block_assemblies": 1, "hd_outer_solves": 6}
    lk.loglik_grid(la, ga, chunk=4)           # blocks cached
    assert lk.metrics.block_assemblies == 1
    met = PTAMetrics()
    met.bump("hd_outer_solves", 24)
    assert met.snapshot()["hd_outer_solves"] == 24
    with pytest.raises(KeyError):
        met.bump("nope")


def test_refusals_name_item_11(like3):
    kw = dict(problems=like3.problems, nfreq=2, device=CPU)
    with pytest.raises(NotImplementedError, match="item 11"):
        GWBLikelihood(mesh=object(), **kw)
    # supervisor= is no longer refused: the likelihood's dispatches
    # ride the given supervisor
    from pint_tpu_torch.runtime import DispatchSupervisor

    sup = DispatchSupervisor()
    GWBLikelihood(supervisor=sup, **kw).loglik(-14.0, 4.0)
    assert sup.metrics.dispatches == 2   # the blocks and one chunk
    with pytest.raises(ValueError):
        GWBLikelihood(problems=like3.problems[:1], device=CPU)
    bare = [PulsarProblem(pr.M, pr.r, pr.nvec, pr.F, pr.phi, pr.names)
            for pr in like3.problems]
    with pytest.raises(ValueError, match="positions"):
        GWBLikelihood(problems=bare, device=CPU)
    assert stack_problems(bare)["M"].shape[0] == 3


@pytest.mark.parametrize("env,want", [(None, 8), ("6", 8), ("32", 32),
                                      ("1000", 8), ("x", 8), ("1", 1)])
def test_gwb_chunk_config(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PINT_TPU_GWB_CHUNK", raising=False)
    else:
        monkeypatch.setenv("PINT_TPU_GWB_CHUNK", env)
    assert config.gwb_chunk() == want == r_config.gwb_chunk()


@pytest.mark.parametrize("env", [None, "24", "bad"])
def test_chain_chunk_steps_config(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("PINT_TPU_CHAIN_CHUNK", raising=False)
    else:
        monkeypatch.setenv("PINT_TPU_CHAIN_CHUNK", env)
    for nsteps in (1, 16, 17, 100, 600, 5000):
        for thin in (1, 3, 5):
            assert config.chain_chunk_steps(nsteps, thin) == \
                r_config.chain_chunk_steps(nsteps, thin), (nsteps, thin)
