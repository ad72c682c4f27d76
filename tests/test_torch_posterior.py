"""The batched linearized posterior of the port
(pint_tpu_torch.sampling: ``build_stretch_chunk``, ``sample_problems``)
on the CPU, on tests/test_sampling.py's problems.

The port's random streams are a counter-based hash, not ``jax.random``,
so the chains cannot match the reference's bits. The oracles are those
of tests/test_sampling.py: the chain's moments against the GLS solution
of the same problem (the reference's ``pta_solve_np``) at
tests/test_sampling.py:387's limits (mean within 0.5 sigma, std ratio in
(0.5, 2), acceptance in (0.1, 0.95)), and the chain's own invariance:
chunked, thinned and re-batched chains bitwise the unchunked chain."""

import numpy as np
import pytest
import torch

from pint_tpu.parallel.pta import pta_solve_np as r_pta_solve_np
from pint_tpu.parallel.pta import stack_problems as r_stack_problems

from pint_tpu_torch.parallel.pta import STACK_KEYS, PulsarProblem, \
    stack_problems
from pint_tpu_torch.sampling import build_stretch_chunk, sample_problems
from pint_tpu_torch.sampling.kernel import normals, uniforms
from pint_tpu_torch.sampling.serve_kernel import make_posterior_slot, \
    posterior_chunk_driver, posterior_system

from test_sampling import _problems

CPU = "cpu"


@pytest.fixture(scope="module")
def problems():
    """tests/test_sampling.py's two problems (40 and 50 TOAs, Offset,
    F0, F1), as host arrays."""
    return [PulsarProblem(p.M, p.r, p.nvec, p.F, p.phi, p.names)
            for p in _problems(2)]


@pytest.mark.parametrize("seed", [42, 7])
def test_sampled_posterior_matches_gls(problems, seed):
    chain, lnp, acc = sample_problems(problems[:1], nwalkers=16,
                                      nsteps=600, seeds=[seed],
                                      device=CPU)[0]
    assert chain.shape == (600, 16, 3) and lnp.shape == (600, 16)
    dparams, cov = r_pta_solve_np(r_stack_problems(problems[:1]))[:2]
    sig = np.sqrt(np.diagonal(cov[0]))
    flat = chain[200:].reshape(-1, chain.shape[-1])
    assert 0.1 < acc < 0.95
    assert np.all(np.abs(flat.mean(axis=0) - dparams[0]) < 0.5 * sig)
    ratio = flat.std(axis=0) / sig
    assert np.all((0.5 < ratio) & (ratio < 2.0))


def test_posterior_system_is_the_gls_solution(problems):
    """The Schur-complemented posterior's mean and marginal sigmas, in
    physical units, are the GLS dparams and sqrt(diag cov) (1e-8)."""
    st = stack_problems(problems)
    sys_ = posterior_system(*(torch.as_tensor(st[k]) for k in STACK_KEYS))
    dparams, cov = r_pta_solve_np(st)[:2]
    mean = (sys_["xhat"] * sys_["scale"]).numpy()
    sig = (sys_["sig"] * torch.abs(sys_["scale"])).numpy()
    np.testing.assert_allclose(mean, dparams, rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(
        sig, np.sqrt(np.diagonal(cov, axis1=1, axis2=2)), rtol=1e-8)
    np.testing.assert_array_equal(sys_["ndim"].numpy(), [3.0, 3.0])


@pytest.mark.parametrize("thin", [1, 4])
def test_chunked_chain_bitwise(problems, thin):
    """The default chunk (one chunk of 128 steps) against chunks of 16:
    the same draws, the same chain, bit for bit; thinning keeps every
    thin-th state of the full chain."""
    full = sample_problems(problems, 16, 100, seeds=[5, 6], device=CPU)
    for chunk in (None, 16):
        got = sample_problems(problems, 16, 100, seeds=[5, 6], thin=thin,
                              chunk=chunk, device=CPU)
        for (c, lp, acc), (fc, flp, facc) in zip(got, full):
            np.testing.assert_array_equal(c, fc[thin - 1::thin])
            np.testing.assert_array_equal(lp, flp[thin - 1::thin])
            assert acc == facc


def test_chunk_driver_progress_and_async(problems):
    """Per-slot budgets (a padded slot runs 0 steps), progress after every
    chunk, and sync=False (chunk 0 enqueued, read in collect) bitwise the
    synchronous drive."""
    st = stack_problems(problems + problems[:1], shape=(3, 50, 3, 0))
    fnv = make_posterior_slot(16, 16)
    args = (fnv, st, [5, 6, 0], [40, 24, 0], 16, 16, 1)
    seen = []
    sync = posterior_chunk_driver(*args, device=CPU,
                                  progress=lambda s: seen.append(list(s)))()
    assert seen == [[16, 16, 0], [32, 24, 0], [40, 24, 0]]
    seen_async = []
    collect = posterior_chunk_driver(
        *args, device=CPU, sync=False,
        progress=lambda s: seen_async.append(list(s)))
    assert seen_async == []
    got = collect()
    assert seen_async == seen
    for a, b in zip(got, sync):
        np.testing.assert_array_equal(a, b)
    chain, lnp, acc, rows = sync
    np.testing.assert_array_equal(rows, [40, 24, 0])
    assert acc[2] == 0 and chain.shape == (3, 40, 16, 3)
    # supervisor= is no longer refused: each chunk is one of its
    # dispatches, and the chain is the same
    from pint_tpu_torch.runtime import DispatchSupervisor

    sup = DispatchSupervisor()
    got = posterior_chunk_driver(*args, device=CPU, supervisor=sup)()
    for a, b in zip(got, sync):
        np.testing.assert_array_equal(a, b)
    assert sup.metrics.dispatches == len(seen)


def test_slot_depends_only_on_its_seed(problems):
    """A problem's chain is the same whichever batch slot it rides in, and
    beside a padded (empty) slot."""
    ab = sample_problems(problems, 16, 40, seeds=[5, 6], device=CPU)
    ba = sample_problems(problems[::-1], 16, 40, seeds=[6, 5], device=CPU)
    padded = sample_problems(problems, 16, 40, seeds=[5, 6], device=CPU,
                             shape=(3, 50, 3, 0))
    for x, y, z in zip(ab, ba[::-1], padded):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[0], z[0])


def test_walker_guard(problems):
    with pytest.raises(ValueError, match="2\\*ndim"):
        sample_problems(problems[:1], nwalkers=4, nsteps=8, seeds=[1],
                        device=CPU)
    with pytest.raises(ValueError, match="2\\*ndim"):
        sample_problems(problems[:1], nwalkers=7, nsteps=8, seeds=[1],
                        device=CPU)


def test_kernel_validates():
    lp = lambda x: -0.5 * (x ** 2).sum(dim=-1)  # noqa: E731
    with pytest.raises(ValueError):
        build_stretch_chunk(lp, 7, 2, 16)     # odd walkers
    with pytest.raises(ValueError):
        build_stretch_chunk(lp, 2, 2, 16)     # < 2*ndim
    with pytest.raises(ValueError):
        build_stretch_chunk(lp, 8, 2, 16, thin=5)  # 5 !| 16


def test_stretch_chunk_budget_and_gaussian():
    """An unbatched ensemble on a 2-d standard normal: a budget of 0 runs
    nothing; a long chain has the target's moments."""
    lp = lambda x: -0.5 * (x ** 2).sum(dim=-1)  # noqa: E731
    chunk = build_stretch_chunk(lp, 8, 2, 256)
    seed = torch.tensor(3, dtype=torch.int64)
    pos = normals(seed, 0, 6, 16).reshape(8, 2)
    out = chunk(pos, lp(pos), seed, 0, 0)
    assert torch.equal(out[0], pos) and int(out[2]) == 0
    flat = []
    for c in range(8):
        pos, lpv, _, chain, _ = chunk(pos, lp(pos), seed, 256, 256 * c)
        flat.append(chain)
    flat = torch.cat(flat[2:]).reshape(-1, 2).numpy()
    assert np.all(np.abs(flat.mean(axis=0)) < 0.15)
    assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.15)


def test_uniforms_positional():
    """Draws depend on (seed, step, stream, element) alone: a range of
    steps drawn at once equals the same steps drawn one by one; values
    lie in (0, 1) with the uniform's mean and spread."""
    seed = torch.tensor([1, 2, -5, 2 ** 40], dtype=torch.int64)
    steps = torch.arange(10, 20, dtype=torch.int64)
    u = uniforms(seed, steps, 6, 8)
    assert u.shape == (4, 10, 6, 8) and u.dtype == torch.float64
    for i in range(10):
        assert torch.equal(u[:, i], uniforms(seed, steps[i:i + 1], 6, 8)[:, 0])
    assert torch.equal(u[:, :, 3:], uniforms(seed, steps, 3, 8,
                                             first_stream=3))
    big = uniforms(seed, torch.arange(1000, dtype=torch.int64), 6, 16)
    assert 0.0 < float(big.min()) and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 0.01
    assert abs(float(big.std()) - (1 / 12) ** 0.5) < 0.01
    # distinct seeds, steps and streams draw distinct numbers
    assert len(np.unique(big.numpy())) > 0.99 * big.numel()
