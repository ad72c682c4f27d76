"""The port's photon-template sampling (pint_tpu_torch.mcmc_fitter
PhotonMCMCFitter and CompositeMCMCFitter) against the reference on the
CPU, on tests/test_mcmc.py's pulsar and photons.

The photon log-likelihood batch matches the reference's within 1e-10
relative; chunks of walkers, ``scan`` against ``host_loop`` and the
device core against the host ``_lp_batch`` are bitwise; the chains
(counter-based streams, not ``jax.random``) recover F0 at the
reference tests' limits."""

import copy
import io
import warnings

import numpy as np
import pytest
import torch

from pint_tpu.mcmc_fitter import CompositeMCMCFitter as RComposite
from pint_tpu.mcmc_fitter import PhotonMCMCFitter as RPhoton
from pint_tpu.templates import LCGaussian as RGaussian
from pint_tpu.templates import LCTemplate as RTemplate
from pint_tpu.toa import get_TOAs_array as r_toas_array

from pint_tpu_torch import config
from pint_tpu_torch.mcmc_fitter import CompositeMCMCFitter, PhotonMCMCFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.templates import LCGaussian, LCTemplate

from test_mcmc import fitted_problem  # noqa: F401 (fixture)

CPU = "cpu"
REL = 1e-10


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def photon_toas(truth, n, seed):
    """tests/test_mcmc.py's photons: phases drawn from its template and
    placed on the truth model's phase grid (reference TOAs)."""
    rng = np.random.default_rng(seed)
    template = RTemplate([RGaussian()], norms=[0.7], locs=[0.4],
                         widths=[0.03])
    base = rng.uniform(55400, 55600, n)
    phi = template.random(n, rng=rng)
    f0, f1, pep = truth.F0.value, truth.F1.value, truth.PEPOCH.value
    k = np.floor((base - pep) * 86400.0 * f0)
    tsec = (k + phi) / f0 - 0.5 * f1 / f0 * ((k + phi) / f0) ** 2
    mjd = pep + tsec / 86400.0
    return _quiet(r_toas_array, np.sort(mjd), obs="barycenter",
                  freqs=np.inf, errors=1.0)


def template(dev=CPU):
    return LCTemplate([LCGaussian()], norms=[0.7], locs=[0.4],
                      widths=[0.03], device=dev)


def port_model(ref, frozen=()):
    m = _quiet(get_model, io.StringIO(ref.as_parfile()), device=CPU)
    for name in frozen:
        m.get_param(name).frozen = True
    m.invalidate_cache()
    return m


@pytest.fixture(scope="module")
def photons(fitted_problem):  # noqa: F811
    truth = fitted_problem[0]
    return truth, photon_toas(truth, 1500, 4)


def walker_points(fitter, n=16, seed=3, rel=1e-11):
    rng = np.random.default_rng(seed)
    return fitter.theta0[None, :] + np.abs(fitter.theta0)[None, :] * rel \
        * rng.standard_normal((n, fitter.nparams))


@pytest.mark.parametrize("weighted", [False, True])
def test_photon_lnlike_batch_matches_reference(photons, weighted):
    truth, rt = photons
    w = np.random.default_rng(8).uniform(0.1, 1.0, rt.ntoas) \
        if weighted else None
    rf = _quiet(RPhoton, rt, copy.deepcopy(truth),
                RTemplate([RGaussian()], [0.7], [0.4], [0.03]), weights=w,
                nwalkers=16, mode="host")
    tf = PhotonMCMCFitter(toas_from_columns(rt, CPU), port_model(truth),
                          template(), weights=w, nwalkers=16, mode="host")
    np.testing.assert_array_equal(tf.theta0, rf.theta0)
    th = walker_points(tf)
    got, want = tf._photon_lnlike_batch(th), rf._photon_lnlike_batch(th)
    np.testing.assert_allclose(got, want, rtol=REL)
    assert np.ptp(got) > 1.0      # the points are told apart


def test_walker_chunks_are_bitwise(photons, monkeypatch):
    truth, rt = photons
    toas = toas_from_columns(rt, CPU)
    th = walker_points(PhotonMCMCFitter(toas, port_model(truth),
                                        template(), nwalkers=16), n=11)
    whole = PhotonMCMCFitter(toas, port_model(truth), template(),
                             nwalkers=16)._photon_lnlike_batch(th)
    for k in (2, 3, 5):
        monkeypatch.setattr(config, "photon_walker_chunk", lambda n: k)
        f = PhotonMCMCFitter(toas, port_model(truth), template(),
                             nwalkers=16)
        np.testing.assert_array_equal(f._photon_lnlike_batch(th), whole)
        np.testing.assert_array_equal(
            f.lnpost_batch(torch.as_tensor(th)).numpy(), whole)


def test_scan_equals_host_loop_and_host_batch(photons):
    """scan against host_loop over 12 steps; the device core against the
    host _lp_batch: bitwise."""
    truth, rt = photons
    toas = toas_from_columns(rt, CPU)
    out = []
    for mode in ("scan", "host_loop"):
        f = PhotonMCMCFitter(toas, port_model(truth), template(),
                             nwalkers=8, rng=np.random.default_rng(6),
                             mode=mode)
        p0 = walker_points(f, n=8, seed=2, rel=2e-12)
        pos = f.sampler.run_mcmc(p0, 12, seed=17, mode=mode)
        out.append((pos, f.sampler.chain, f.sampler.lnprob,
                    f.sampler.naccepted))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert 0 < out[0][3] < 8 * 12
    th = walker_points(f)
    np.testing.assert_array_equal(
        f.lnpost_batch(torch.as_tensor(th)).numpy(), f._lp_batch(th))


def test_photon_mcmc_recovers_f0(photons):
    """tests/test_mcmc.py:118's recovery and limits, F1 frozen, on the
    default (scan) sampler."""
    truth, rt = photons
    m = port_model(truth, frozen=("F1",))
    fitter = PhotonMCMCFitter(toas_from_columns(rt, CPU), m, template(),
                              nwalkers=16, rng=np.random.default_rng(2))
    lnmax = fitter.fit_toas(nsteps=150, scatter=2e-12)
    assert np.isfinite(lnmax)
    assert fitter.param_labels == ["F0"]
    assert abs(m.F0.value - truth.F0.value) < 5e-8
    assert fitter.errors["F0"] < 1e-7
    assert 0.1 < fitter.sampler.acceptance_fraction < 0.95


def test_composite_matches_reference_and_recovers(fitted_problem):  # noqa: F811,E501
    """The joint posterior batch against the reference's within 1e-10
    relative, then tests/test_mcmc.py:188's fit and limits."""
    truth, _, toas_radio, _ = fitted_problem
    toas_ev = photon_toas(truth, 1200, 9)
    rm = copy.deepcopy(truth)
    for nm in rm.free_params:
        if nm != "F0":
            rm.get_param(nm).frozen = True
    rm.invalidate_cache()
    rf = _quiet(RComposite, toas_radio, toas_ev, rm,
                RTemplate([RGaussian()], [0.7], [0.4], [0.03]), nwalkers=8)
    m = port_model(rm)
    fitter = CompositeMCMCFitter(
        toas_from_columns(toas_radio, CPU), toas_from_columns(toas_ev, CPU),
        m, template(), nwalkers=8, rng=np.random.default_rng(10))
    th = walker_points(fitter, n=8, rel=1e-12)
    np.testing.assert_allclose(fitter._lp_batch(th), rf._lp_batch(th),
                               rtol=REL)
    lnmax = fitter.fit_toas(nsteps=60)
    assert np.isfinite(lnmax)
    assert m.F0.value == pytest.approx(truth.F0.value,
                                       abs=5 * m.F0.uncertainty)
    assert 0 < m.F0.uncertainty < 1e-5
