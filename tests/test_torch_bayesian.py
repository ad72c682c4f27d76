"""The Bayesian surfaces of the port (pint_tpu_torch.models.priors,
.bayesian, .sampling.likelihood, .sampling.posterior) against the
reference pint_tpu on the CPU, on tests/test_sampling.py's pulsar: 60
TOAs with white noise, and 50 clustered TOAs with EFAC, ECORR and 5
red-noise modes (``_mk``).

The port model is built from the reference model's par output and the
port TOAs hold the reference TOAs' host columns, so both evaluate the
same inputs. Priors are carried across with ``prior_from_reference``.
The likelihoods are held to the reference's to 1e-10 relative; the
reference's compiled and eager values agree to ~1e-16 on this isolated
pulsar, so the compiled reference is the oracle."""

import copy
import io
import math

import numpy as np
import pytest
import torch

from pint_tpu.bayesian import BayesianTiming as RBayesianTiming
from pint_tpu.models import priors as rpriors
from pint_tpu.sampling import DevicePosterior as RDevicePosterior
from pint_tpu.sampling import SampledNoiseLikelihood as \
    RSampledNoiseLikelihood

from pint_tpu_torch.bayesian import BayesianTiming
from pint_tpu_torch.models import get_model, priors
from pint_tpu_torch.models.convert import prior_from_reference, \
    toas_from_columns
from pint_tpu_torch.sampling import DevicePosterior, SampledNoiseLikelihood

from test_sampling import _mk
from test_torch_photon import _quiet

CPU = "cpu"
REL = 1e-10


def port_of(rm, rt):
    """(port model, port TOAs) of a reference pair, with the reference's
    priors carried across."""
    tm = _quiet(get_model, io.StringIO(rm.as_parfile()), device=CPU)
    for c in rm.components.values():
        for name, p in c.params.items():
            if getattr(p, "prior", None) is not None:
                tm.get_param(name).prior = prior_from_reference(p.prior)
    return tm, toas_from_columns(rt, CPU)


@pytest.fixture(scope="module")
def white():
    """tests/test_sampling.py's 60-TOA pulsar (F0 and F1 free) with
    Gaussian priors on both (its ``posterior`` fixture)."""
    rm, rt = _mk()
    for name in ("F0", "F1"):
        p = rm.get_param(name)
        p.prior = rpriors.GaussianPrior(p.value,
                                        max(abs(p.value) * 1e-9, 1e-18))
    return (rm, rt) + port_of(rm, rt)


@pytest.fixture(scope="module")
def noisy():
    """The 50-TOA EFAC/ECORR/red-noise pulsar (``noise_pair``)."""
    rm, rt = _mk(ntoa=50, noise=True, seed=23)
    return (rm, rt) + port_of(rm, rt)


def theta_points(bt, n=5, seed=3):
    """``n`` parameter points about theta0: a few 1e-10-relative moves
    and points a posterior sampler visits (1e-12 relative)."""
    rng = np.random.default_rng(seed)
    th0 = bt.theta0
    out = [th0.copy()]
    for k in range(1, n):
        scale = 1e-10 if k % 2 else 1e-12
        out.append(th0 + scale * rng.standard_normal(len(th0)) * th0)
    return np.array(out)


# ------------------------------------------------------------- priors

PRIOR_POINTS = np.array([-3.0, -1.0, -0.25, 0.0, 0.3, 0.8, 1.0, 1.7, 2.0,
                         2.5, 10.0])
Q_POINTS = np.array([1e-9, 0.01, 0.25, 0.5, 0.75, 0.99, 1 - 1e-9])


@pytest.mark.parametrize("name,args", [
    ("Prior", ()), ("UniformUnboundedPrior", ()),
    ("UniformPrior", (0.0, 2.0)), ("UniformPrior", (-1.0, 0.8)),
    ("GaussianPrior", (1.0, 2.0)), ("GaussianPrior", (-13.5, 0.3))])
def test_prior_matches_reference(name, args):
    """logpdf (a float and a tensor of points, -inf outside a
    UniformPrior's bounds), pdf and ppf equal the reference's within
    1e-15 relative; the improper priors refuse ppf as it does."""
    ref = getattr(rpriors, name)(*args)
    got = getattr(priors, name)(*args)
    want = np.asarray(ref.logpdf(PRIOR_POINTS))
    vec = got.logpdf(torch.as_tensor(PRIOR_POINTS))
    assert vec.dtype == torch.float64 and vec.shape == PRIOR_POINTS.shape
    scal = np.array([float(got.logpdf(float(x))) for x in PRIOR_POINTS])
    for val in (vec.numpy(), scal):
        np.testing.assert_array_equal(np.isfinite(val), np.isfinite(want))
        np.testing.assert_array_equal(val[~np.isfinite(want)],
                                      want[~np.isfinite(want)])
        fin = np.isfinite(want)
        np.testing.assert_allclose(val[fin], want[fin], rtol=1e-15,
                                   atol=0)
    np.testing.assert_allclose(got.pdf(torch.as_tensor(PRIOR_POINTS)),
                               np.asarray(ref.pdf(PRIOR_POINTS)),
                               rtol=1e-15)
    if name in ("Prior", "UniformUnboundedPrior"):
        with pytest.raises(ValueError):
            got.ppf(0.5)
        return
    np.testing.assert_allclose(got.ppf(torch.as_tensor(Q_POINTS)).numpy(),
                               np.asarray(ref.ppf(Q_POINTS)),
                               rtol=1e-15, atol=1e-15)
    assert float(got.ppf(0.5)) == pytest.approx(float(ref.ppf(0.5)),
                                                rel=1e-15, abs=1e-15)


def test_log10_prior_and_prior_from_reference():
    """Log10TransformedPrior keeps the change-of-variables term
    eta ln10 + ln ln10 (p_eta = p_v(10^eta) 10^eta ln10) and matches the
    reference; prior_from_reference maps every reference class to the
    port's by name and attributes; the constructors refuse what the
    reference's refuse."""
    base = rpriors.GaussianPrior(0.8, 0.1)
    ref = rpriors.Log10TransformedPrior(base)
    got = prior_from_reference(ref)
    assert isinstance(got, priors.Log10TransformedPrior)
    assert isinstance(got.base, priors.GaussianPrior)
    assert (got.base.mu, got.base.sigma) == (0.8, 0.1)
    etas = np.array([-0.2, np.log10(0.8), 0.1, 0.8])
    np.testing.assert_allclose(got.logpdf(torch.as_tensor(etas)).numpy(),
                               np.asarray(ref.logpdf(etas)), rtol=1e-15)
    for eta in etas:
        v = 10.0 ** eta
        assert float(got.logpdf(eta)) == pytest.approx(
            float(got.base.logpdf(v)) + math.log(v * math.log(10.0)),
            rel=1e-12)
    u = prior_from_reference(
        rpriors.Log10TransformedPrior(rpriors.UniformPrior(0.1, 10.0)))
    np.testing.assert_allclose(
        u.ppf(torch.as_tensor(Q_POINTS)).numpy(),
        np.asarray(rpriors.Log10TransformedPrior(
            rpriors.UniformPrior(0.1, 10.0)).ppf(Q_POINTS)), rtol=1e-15)
    for obj in (rpriors.Prior(), rpriors.UniformUnboundedPrior(),
                rpriors.UniformPrior(-2.0, 3.0),
                rpriors.GaussianPrior(5.0, 0.5)):
        mapped = prior_from_reference(obj)
        assert type(mapped).__name__ == type(obj).__name__
        assert repr(mapped) == repr(obj)
    assert prior_from_reference(None) is None
    with pytest.raises(TypeError):
        prior_from_reference(object())
    with pytest.raises(ValueError):
        priors.UniformPrior(1.0, 1.0)
    with pytest.raises(ValueError):
        priors.GaussianPrior(0.0, 0.0)


def test_prior_logpdf_under_vmap():
    """logpdf maps over a batch under torch.func.vmap (the posterior's
    per-walker priors), bitwise the plain batch call."""
    x = torch.as_tensor(PRIOR_POINTS)
    for p in (priors.UniformPrior(0.0, 2.0), priors.GaussianPrior(1.0, 2.0),
              priors.Log10TransformedPrior(priors.GaussianPrior(0.8, 0.1)),
              priors.Prior()):
        torch.testing.assert_close(torch.func.vmap(p.logpdf)(x),
                                   p.logpdf(x), rtol=0, atol=0)


def test_parameter_prior_hook(white):
    """Parameter.prior_logpdf: 0 without a prior, the prior's log-density
    with one (reference: tests/test_bayesian.py)."""
    tm = copy.deepcopy(white[2])
    p = tm.get_param("DM")
    assert p.prior_logpdf() == 0.0
    p.prior = priors.GaussianPrior(p.value, 1e-3)
    assert float(p.prior_logpdf(p.value)) == pytest.approx(
        -math.log(1e-3 * math.sqrt(2.0 * math.pi)))
    assert float(tm.get_param("F0").prior_logpdf()) > 0


# --------------------------------------------------- BayesianTiming


@pytest.mark.parametrize("case", ["white", "noisy"])
def test_bayesian_timing_matches_reference(case, white, noisy):
    """At 5 theta points: lnlikelihood, lnprior and lnposterior equal the
    reference's (1e-10 relative), the batch equals the scalar calls, and
    a point outside a UniformPrior gives -inf in both."""
    rm, rt, tm, tt = white if case == "white" else noisy
    rb, pb = RBayesianTiming(rm, rt), BayesianTiming(tm, tt)
    assert pb.param_labels == rb.param_labels
    np.testing.assert_array_equal(pb.theta0, rb.theta0)
    np.testing.assert_array_equal(pb._tl0, rb._tl0)
    assert pb._lnnorm == pytest.approx(rb._lnnorm, rel=1e-13)
    pts = theta_points(rb)
    for th in pts:
        assert pb.lnlikelihood(th) == pytest.approx(rb.lnlikelihood(th),
                                                    rel=REL)
        assert pb.lnprior(th) == pytest.approx(rb.lnprior(th), rel=REL,
                                               abs=1e-12)
        assert pb.lnposterior(th) == pytest.approx(rb.lnposterior(th),
                                                   rel=REL)
    batch = pb.lnlikelihood_batch(pts)
    np.testing.assert_allclose(batch, [pb.lnlikelihood(t) for t in pts],
                               rtol=REL)
    np.testing.assert_allclose(pb.lnposterior_batch(pts),
                               rb.lnposterior_batch(pts), rtol=REL)
    # a UniformPrior on F1: inside it both agree, outside both give -inf
    f1 = rm.get_param("F1").value
    rm2, tm2 = copy.deepcopy(rm), copy.deepcopy(tm)
    rm2.get_param("F1").prior = rpriors.UniformPrior(f1 - 1e-20, f1 + 1e-20)
    tm2.get_param("F1").prior = priors.UniformPrior(f1 - 1e-20, f1 + 1e-20)
    rb2, pb2 = RBayesianTiming(rm2, rt), BayesianTiming(tm2, tt)
    k = pb2.param_labels.index("F1")
    bad = pts[:2].copy()
    bad[1, k] += 1e-18
    got, want = pb2.lnposterior_batch(bad), rb2.lnposterior_batch(bad)
    assert got[1] == want[1] == -np.inf
    assert got[0] == pytest.approx(want[0], rel=REL)
    assert pb2.lnposterior(bad[1]) == -np.inf


def test_prior_transform_matches_reference(white):
    """prior_transform maps the unit cube through each ppf as the
    reference's does, and refuses a parameter without a proper prior."""
    rm, rt, tm, tt = white
    rm2, tm2 = copy.deepcopy(rm), copy.deepcopy(tm)
    v = rm2.get_param("F0").value
    rm2.get_param("F0").prior = rpriors.UniformPrior(v - 1e-6, v + 1e-6)
    tm2.get_param("F0").prior = prior_from_reference(
        rm2.get_param("F0").prior)
    rb, pb = RBayesianTiming(rm2, rt), BayesianTiming(tm2, tt)
    for q in (0.5, 0.1, 0.93):
        cube = np.full(pb.nparams, q)
        np.testing.assert_allclose(pb.prior_transform(cube),
                                   rb.prior_transform(cube), rtol=1e-15)
    tm3 = copy.deepcopy(tm)
    tm3.get_param("F0").prior = None
    with pytest.raises(ValueError):
        BayesianTiming(tm3, tt).prior_transform(np.full(pb.nparams, 0.5))


# ---------------------------------------- noise-sampled likelihood


def test_sampled_noise_matches_reference(noisy):
    """The reference's labels and eta0, its likelihood at 3 eta points
    (1e-10 relative), pinned equal to the fixed-noise BayesianTiming and
    moved equal to a BayesianTiming rebuilt at the moved hyperparameters
    (1e-9, tests/test_sampling.py:228 and :250)."""
    rm, rt, tm, tt = noisy
    rs, ps = RSampledNoiseLikelihood(rm, rt), SampledNoiseLikelihood(tm, tt)
    assert ps.labels == rs.labels == [
        "ECORR1.log10", "PLRedNoise.log10_A", "PLRedNoise.gamma"]
    np.testing.assert_array_equal(ps.eta0, rs.eta0)
    pts = theta_points(BayesianTiming(tm, tt), n=3, seed=5)
    for eta in (ps.eta0, ps.eta0 + [0.1, 0.3, -0.4],
                ps.eta0 + [-0.3, -0.5, 0.6]):
        for th in pts:
            assert ps.lnlikelihood(th, eta) == pytest.approx(
                rs.lnlikelihood(th, eta), rel=REL)
    bt = BayesianTiming(tm, tt)
    for th in pts:
        assert ps.lnlikelihood(th, ps.eta0) == pytest.approx(
            bt.lnlikelihood(th), rel=1e-9)
    eta1 = ps.eta0 + np.array([0.1, 0.3, -0.4])
    m2 = copy.deepcopy(tm)
    m2.get_param("ECORR1").value = 10.0 ** eta1[0]
    m2.get_param("TNREDAMP").value = eta1[1]
    m2.get_param("TNREDGAM").value = eta1[2]
    m2.invalidate_cache()
    bt2 = BayesianTiming(m2, tt)
    for th in pts[:2]:
        assert ps.lnlikelihood(th, eta1) == pytest.approx(
            bt2.lnlikelihood(th), rel=1e-9)
    assert ps.lnlikelihood(pts[0], eta1) != pytest.approx(
        ps.lnlikelihood(pts[0], ps.eta0), rel=1e-12)


def test_sampled_noise_refusals(white, noisy):
    """A model without noise dimensions raises ValueError; an ECORR
    epoch map that drifted from the segments raises RuntimeError."""
    _, _, tm, tt = white
    with pytest.raises(ValueError, match="no sampled noise"):
        SampledNoiseLikelihood(tm, tt)
    from pint_tpu_torch.sampling import likelihood

    _, _, tm, tt = noisy
    seg = tm.noise_model_ecorr_segments(tt)
    with pytest.raises(RuntimeError, match="drifted"):
        likelihood._ecorr_epoch_params(tm, tt, seg[1][1:])
    jv = seg[1].copy()
    jv[0] *= 1.5
    with pytest.raises(RuntimeError, match="mismatch"):
        likelihood._ecorr_epoch_params(tm, tt, jv)


def test_non_pd_sff_is_never_accepted(noisy):
    """A walker whose Sff is not positive definite scores NaN (no
    exception, no sync), and the other walkers of the batch are
    untouched."""
    _, _, tm, tt = noisy
    post = DevicePosterior(tm, tt, sample_noise=True)
    good = post.theta0.copy()
    bad = good.copy()
    bad[post.ntiming + 1] = 400.0     # phi = inf: 1/phi = 0, Sff singular
    bad2 = good.copy()
    bad2[post.ntiming + 2] = np.nan
    lp = post.lnpost_batch(torch.as_tensor(np.array([good, bad, bad2])))
    assert np.isfinite(float(lp[0]))
    assert not np.isfinite(lp[1:].numpy()).any()
    assert float(lp[0]) == float(post.lnpost_one(torch.as_tensor(good)))


# ---------------------------------------------------- DevicePosterior


@pytest.mark.parametrize("sample_noise", [False, True])
def test_device_posterior_matches_reference(sample_noise, white, noisy):
    """lnpost_batch at the same walker array equals the reference's
    (1e-10 relative), init_walkers is bitwise the reference's under the
    same numpy seed, and the labels, theta0 and scales agree."""
    rm, rt, tm, tt = noisy if sample_noise else white
    rp = RDevicePosterior(rm, rt, sample_noise=sample_noise)
    pp = DevicePosterior(tm, tt, sample_noise=sample_noise)
    assert pp.param_labels == rp.param_labels
    assert pp.ntiming == rp.ntiming and pp.nparams == rp.nparams
    np.testing.assert_array_equal(pp.theta0, rp.theta0)
    np.testing.assert_array_equal(pp.init_scales(), rp.init_scales())
    W = 2 * pp.nparams + 2
    p0 = pp.init_walkers(W, rng=np.random.default_rng(4), scatter=0.2)
    np.testing.assert_array_equal(
        p0, rp.init_walkers(W, rng=np.random.default_rng(4), scatter=0.2))
    got = pp.lnpost_batch(torch.as_tensor(p0)).numpy()
    want = np.asarray(rp.lnpost_batch(p0))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=REL)
    one = float(pp.lnpost_one(torch.as_tensor(p0[0])))
    assert one == pytest.approx(float(got[0]), rel=REL)


def test_ecorr_prior_change_of_variables(noisy):
    """A prior over the linear ECORR value is sampled through
    Log10TransformedPrior, and the posterior picks it up as the
    reference's does."""
    rm, rt, tm, tt = noisy
    rm2, tm2 = copy.deepcopy(rm), copy.deepcopy(tm)
    rm2.get_param("ECORR1").prior = rpriors.GaussianPrior(0.8, 0.1)
    tm2.get_param("ECORR1").prior = priors.GaussianPrior(0.8, 0.1)
    ps = SampledNoiseLikelihood(tm2, tt)
    assert isinstance(ps.priors[0], priors.Log10TransformedPrior)
    rp = RDevicePosterior(rm2, rt, sample_noise=True)
    pp = DevicePosterior(tm2, tt, sample_noise=True)
    p0 = pp.init_walkers(8, rng=np.random.default_rng(1), scatter=0.3)
    np.testing.assert_allclose(pp.lnpost_batch(torch.as_tensor(p0)).numpy(),
                               np.asarray(rp.lnpost_batch(p0)), rtol=REL)


def test_entry_points_default_to_cuda():
    """Without a GPU the port's model, and so BayesianTiming and
    DevicePosterior on it, cannot be built on the default device, and
    the device sampler refuses it: no quiet CPU fallback."""
    from pint_tpu_torch.sampling import DeviceEnsembleSampler

    if torch.cuda.is_available():
        s = DeviceEnsembleSampler(4, 2, lambda x: x[:, 0])
        assert s.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DeviceEnsembleSampler(4, 2, lambda x: x[:, 0])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _quiet(get_model, io.StringIO("PSR X\nF0 1.0 1\nPEPOCH 55000\n"))

