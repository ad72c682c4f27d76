"""The port's chains (pint_tpu_torch.sampling.chain, .sampler,
.mcmc_fitter) on the CPU, on tests/test_sampling.py's pulsar and
tests/test_mcmc.py's fitted problem.

The port's random streams are a counter-based hash, not ``jax.random``,
so a device chain cannot match the reference's bits. Its oracles are
those of tests/test_sampling.py: ``scan`` is bitwise ``host_loop`` (the
same positional draws), chunking and thinning change no bit, and the
chain's moments agree with the WLS fit and with the reference's chain
within Monte-Carlo error. The host ``EnsembleSampler`` is numpy, so with
the same generator it is bitwise the reference's."""

import copy

import numpy as np
import pytest
import torch

from pint_tpu.mcmc_fitter import MCMCFitter as RMCMCFitter
from pint_tpu.models import priors as rpriors
from pint_tpu.sampler import EnsembleSampler as REnsembleSampler
from pint_tpu.sampling import DeviceEnsembleSampler as RDeviceSampler
from pint_tpu.sampling import DevicePosterior as RDevicePosterior

from pint_tpu_torch.mcmc_fitter import MCMCFitter
from pint_tpu_torch.sampler import ChainStats, EnsembleSampler
from pint_tpu_torch.sampling import DeviceEnsembleSampler, DevicePosterior

from test_mcmc import fitted_problem  # noqa: F401 (fixture)
from test_sampling import _mk
from test_torch_bayesian import port_of

CPU = "cpu"


@pytest.fixture(scope="module")
def posterior():
    """The port's fixed-noise DevicePosterior of the 60-TOA pulsar with
    tests/test_sampling.py's Gaussian priors on F0 and F1."""
    rm, rt = _mk()
    for name in ("F0", "F1"):
        p = rm.get_param(name)
        p.prior = rpriors.GaussianPrior(p.value,
                                        max(abs(p.value) * 1e-9, 1e-18))
    return DevicePosterior(*port_of(rm, rt))


@pytest.fixture(scope="module")
def noisy():
    """(reference model, reference TOAs, port model, port TOAs) of the
    50-TOA EFAC/ECORR/red-noise pulsar."""
    rm, rt = _mk(ntoa=50, noise=True, seed=23)
    return (rm, rt) + port_of(rm, rt)


def _sampler(posterior, nwalkers=8, thin=1):
    return DeviceEnsembleSampler(nwalkers, posterior.nparams,
                                 posterior.lnpost_batch, thin=thin,
                                 device=CPU)


def test_sampler_validates(posterior):
    with pytest.raises(ValueError):
        DeviceEnsembleSampler(3, 2, posterior.lnpost_batch, device=CPU)
    s = _sampler(posterior)
    with pytest.raises(ValueError):
        s.run_mcmc(np.zeros((4, 2)), 8)       # wrong p0 shape
    with pytest.raises(ValueError):
        s.run_mcmc(posterior.init_walkers(8), 8, mode="bogus")
    with pytest.raises(ValueError):
        s.run_mcmc(posterior.init_walkers(8), 0)
    nan = np.full((8, posterior.nparams), np.nan)
    with pytest.raises(ValueError, match="finite"):
        s.run_mcmc(nan, 8)


def test_scan_bit_identical_to_host_loop(posterior):
    """One chunk against one call a step: the same positional draws, so
    bitwise-equal chains, lnprob, acceptance and final ensemble."""
    p0 = posterior.init_walkers(8, rng=np.random.default_rng(5))
    host = _sampler(posterior)
    pos_h = host.run_mcmc(p0, 48, seed=7, mode="host_loop")
    scan = _sampler(posterior)
    pos_s = scan.run_mcmc(p0, 48, seed=7, mode="scan")
    assert host.dispatches == 48 and scan.dispatches == 1
    np.testing.assert_array_equal(pos_h, pos_s)
    np.testing.assert_array_equal(host.chain, scan.chain)
    np.testing.assert_array_equal(host.lnprob, scan.lnprob)
    assert host.naccepted == scan.naccepted
    assert 0 < scan.acceptance_fraction <= 1.0
    scan.reset_dispatch_count()
    assert scan.dispatches == 0


def test_chunked_chain_bit_identical(posterior, monkeypatch):
    """A chain cut into chunks of 16 by $PINT_TPU_CHAIN_CHUNK, and one
    whose last chunk runs past its budget, are bitwise the host-loop
    chain."""
    p0 = posterior.init_walkers(8, rng=np.random.default_rng(5))
    host = _sampler(posterior)
    host.run_mcmc(p0, 40, seed=7, mode="host_loop")
    monkeypatch.setenv("PINT_TPU_CHAIN_CHUNK", "16")
    chunked = _sampler(posterior)
    chunked.run_mcmc(p0, 40, seed=7, mode="scan")
    assert chunked.dispatches == 3           # 16 + 16 + 8 of 16
    monkeypatch.delenv("PINT_TPU_CHAIN_CHUNK")
    whole = _sampler(posterior)               # one chunk of 64, budget 40
    whole.run_mcmc(p0, 40, seed=7, mode="scan")
    assert whole.dispatches == 1
    for s in (chunked, whole):
        assert s.chain.shape == (40, 8, posterior.nparams)
        np.testing.assert_array_equal(s.chain, host.chain)
        np.testing.assert_array_equal(s.lnprob, host.lnprob)
        assert s.naccepted == host.naccepted


def test_thinned_chain_matches_strided_full(posterior):
    """thin=4 keeps exactly every 4th state of the thin=1 chain, in scan
    and in host_loop; a step count thin does not divide is refused."""
    p0 = posterior.init_walkers(8, rng=np.random.default_rng(2))
    full = _sampler(posterior)
    full.run_mcmc(p0, 32, seed=3, mode="scan")
    thin = _sampler(posterior, thin=4)
    thin.run_mcmc(p0, 32, seed=3, mode="scan")
    assert thin.chain.shape[0] == 8
    np.testing.assert_array_equal(thin.chain, full.chain[3::4])
    np.testing.assert_array_equal(thin.lnprob, full.lnprob[3::4])
    hthin = _sampler(posterior, thin=4)
    hthin.run_mcmc(p0, 32, seed=3, mode="host_loop")
    np.testing.assert_array_equal(hthin.chain, thin.chain)
    np.testing.assert_array_equal(hthin.lnprob, thin.lnprob)
    with pytest.raises(ValueError):
        thin.run_mcmc(p0, 30, seed=3)


def _mc_error(chain):
    """Standard error of each parameter's chain mean: the std over the
    draws scaled by sqrt(tau / draws), tau the walker-averaged integrated
    autocorrelation time (ChainStats.get_autocorr_time, at least 1),
    counting the walkers as one chain (conservative: they are coupled).
    Returns (mean, std, standard error)."""
    st = ChainStats()
    st.chain, st.ndim = chain, chain.shape[-1]
    tau = np.nan_to_num(st.get_autocorr_time(), nan=chain.shape[0])
    flat = chain.reshape(-1, chain.shape[-1])
    std = flat.std(axis=0)
    return flat.mean(axis=0), std, \
        std * np.sqrt(np.maximum(tau, 1.0) / chain.shape[0])


def test_device_chain_moments_match_reference(fitted_problem):  # noqa: F811
    """tests/test_mcmc.py's fitted problem, walkers started within the
    WLS sigmas: 300 steps of 16 walkers, after 100 the chain's mean
    within 1 WLS sigma of the fit and its width within 25 % of the WLS
    sigma (tests/test_sampling.py:210, test_mcmc.py:95), and its means and
    widths those of the reference's chain from the same start within
    Monte-Carlo error (5 standard errors; widths within 10 %)."""
    _, mfit, rt, wls = fitted_problem
    tm, tt = port_of(mfit, rt)
    rpost, post = RDevicePosterior(mfit, rt), DevicePosterior(tm, tt)
    p0 = post.init_walkers(16, rng=np.random.default_rng(8))
    s = _sampler(post, nwalkers=16)
    s.run_mcmc(p0, 300, seed=1, mode="scan")
    r = RDeviceSampler(16, rpost.nparams, rpost.lnpost_batch)
    r.run_mcmc(p0, 300, seed=1, mode="scan")
    mean, std, se = _mc_error(s.chain[100:])
    rmean, rstd, rse = _mc_error(r.chain[100:])
    for k, name in enumerate(post.param_labels):
        sig = wls.errors[name]
        assert abs(mean[k] - post.theta0[k]) < sig, name
        assert 0.75 < std[k] / sig < 1.25, name
        assert abs(mean[k] - rmean[k]) < 5 * np.hypot(se[k], rse[k]), name
        assert 0.9 < std[k] / rstd[k] < 1.1, name
    assert 0.1 < s.acceptance_fraction < 0.95


def test_noise_sampled_chain(noisy):
    """sample_noise=True: the chain over timing + noise dimensions,
    scan bitwise host_loop, finite, and the red-noise amplitude moves."""
    _, _, tm, tt = noisy
    post = DevicePosterior(tm, tt, sample_noise=True)
    assert post.param_labels[post.ntiming:] == [
        "ECORR1.log10", "PLRedNoise.log10_A", "PLRedNoise.gamma"]
    W = 2 * post.nparams + 2
    p0 = post.init_walkers(W, rng=np.random.default_rng(4), scatter=0.2)
    scan = DeviceEnsembleSampler(W, post.nparams, post.lnpost_batch,
                                 device=CPU)
    scan.run_mcmc(p0, 24, seed=9, mode="scan")
    host = DeviceEnsembleSampler(W, post.nparams, post.lnpost_batch,
                                 device=CPU)
    host.run_mcmc(p0, 24, seed=9, mode="host_loop")
    np.testing.assert_array_equal(scan.chain, host.chain)
    np.testing.assert_array_equal(scan.lnprob, host.lnprob)
    assert np.all(np.isfinite(scan.lnprob))
    assert scan.naccepted > 0
    assert np.ptp(scan.chain[:, :, post.ntiming + 1]) > 0


# --------------------------------------------------- host sampler


def _gauss_lp():
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    icov = np.linalg.inv(cov)

    def lp(x):
        x = np.atleast_2d(x)
        return -0.5 * np.einsum("si,ij,sj->s", x, icov, x)

    return cov, lp


def test_host_sampler_bitwise_reference():
    """EnsembleSampler and ChainStats on tests/test_mcmc.py's Gaussian
    target: the chain, lnprob, acceptance, autocorrelation times and
    convergence verdict bitwise the reference's under the same generator,
    and the moments the target's."""
    cov, lp = _gauss_lp()
    out = []
    for cls in (EnsembleSampler, REnsembleSampler):
        rng = np.random.default_rng(0)
        s = cls(40, 2, lp, rng=rng)
        p0 = rng.standard_normal((40, 2))
        pos = s.run_mcmc(p0, 1500)
        out.append((s, pos))
    (s, pos), (r, rpos) = out
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(s.chain, r.chain)
    np.testing.assert_array_equal(s.lnprob, r.lnprob)
    assert s.naccepted == r.naccepted and s.niterations == r.niterations
    np.testing.assert_array_equal(s.get_autocorr_time(),
                                  r.get_autocorr_time())
    assert s.converged() == r.converged()
    assert s.converged(factor=5.0) == r.converged(factor=5.0)
    np.testing.assert_array_equal(s.get_chain(discard=500, thin=3, flat=True),
                                  r.get_chain(discard=500, thin=3, flat=True))
    assert 0.2 < s.acceptance_fraction < 0.9
    flat = s.get_chain(discard=500, flat=True)
    np.testing.assert_allclose(np.cov(flat.T), cov, rtol=0.15, atol=0.1)


def test_host_sampler_validates():
    _, lp = _gauss_lp()
    with pytest.raises(ValueError):
        EnsembleSampler(3, 2, lp)
    with pytest.raises(ValueError):
        EnsembleSampler(2, 2, lp)
    s = EnsembleSampler(8, 2, lambda x: np.full(len(np.atleast_2d(x)),
                                                -np.inf))
    with pytest.raises(ValueError):
        s.run_mcmc(np.zeros((8, 2)), 5)
    with pytest.raises(ValueError):
        s.get_chain()


# --------------------------------------------------------- MCMCFitter


@pytest.mark.parametrize("mode", ["scan", "host"])
def test_mcmc_fitter_matches_wls(mode, fitted_problem):  # noqa: F811
    """tests/test_mcmc.py:95 on the port: the posterior width within a
    factor ~2 of the WLS sigma and the median within 4 sigma of the WLS
    solution, in the device and the host modes."""
    _, mfit, rt, wls = fitted_problem
    tm, tt = port_of(mfit, rt)
    mc = MCMCFitter(tt, tm, nwalkers=16, rng=np.random.default_rng(1),
                    mode=mode)
    chi2 = mc.fit_toas(nsteps=200)
    assert np.isfinite(chi2) and mc.stats is not None
    assert mc.sampler.acceptance_fraction > 0.1
    for name in ("F0", "F1"):
        assert 0.4 < mc.errors[name] / wls.errors[name] < 2.5, name
        assert abs(tm.get_param(name).value
                   - mfit.get_param(name).value) \
            < 4 * wls.errors[name], name


def test_mcmc_fitter_sample_noise(noisy):
    """sample_noise=True fills noise_estimates and never writes the
    timing model's noise parameters; mode='host' refuses sample_noise, as
    the reference does; the ensemble is sized as the reference sizes
    it."""
    rm, rt, tm, tt = noisy
    m = copy.deepcopy(tm)
    mc = MCMCFitter(tt, m, nwalkers=4, sample_noise=True,
                    rng=np.random.default_rng(6))
    ref = RMCMCFitter(rt, copy.deepcopy(rm), nwalkers=4, sample_noise=True,
                      rng=np.random.default_rng(6))
    assert mc.nwalkers == ref.nwalkers == 12
    assert mc.param_labels == ref.param_labels
    np.testing.assert_array_equal(mc._init_walkers(0.5),
                                  ref._init_walkers(0.5))
    chi2 = mc.fit_toas(nsteps=30)
    assert np.isfinite(chi2)
    assert set(mc.noise_estimates) == {
        "ECORR1.log10", "PLRedNoise.log10_A", "PLRedNoise.gamma"}
    for v in mc.noise_estimates.values():
        assert np.isfinite(v["median"]) and v["std"] >= 0
    assert m.get_param("TNREDAMP").value == -13.5
    assert m.get_param("ECORR1").value == tm.get_param("ECORR1").value
    with pytest.raises(ValueError):
        MCMCFitter(tt, m, mode="host", sample_noise=True)
    assert isinstance(mc.sampler, DeviceEnsembleSampler)
    assert mc.sampler.device == torch.device(CPU)
