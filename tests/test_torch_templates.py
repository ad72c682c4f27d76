"""The port's pulse-profile templates (pint_tpu_torch.templates) against
the reference (pint_tpu.templates) on the CPU: every primitive's pdf,
fwhm, pack/unpack, integrate and draws, a mixed template's statistics,
template files read across the two packages, GaussianPrior, and
LCFitter's unbinned (with and without a free mask) and binned fits."""

import numpy as np
import pytest
import torch

import pint_tpu.templates as R
import pint_tpu_torch.templates as T

CPU = "cpu"
PHASES = np.random.default_rng(0).uniform(-0.5, 1.5, 4096)
REL = 1e-13
SPECS = {
    "gaussian": ("gaussian", 0.55, 0.3, 0.03),
    "gaussian2": ("gaussian2", 0.5, 0.35, [0.02, 0.05]),
    "vonmises": ("vonmises", 0.5, 0.7, 0.04),
    "lorentzian": ("lorentzian", 0.45, 0.95, 0.02),
    "lorentzian2": ("lorentzian2", 0.5, 0.05, [0.02, 0.05]),
    "tophat": ("tophat", 0.6, 0.5, 0.2),
    "skewgaussian": ("skewgaussian", 0.5, 0.3, [0.03, 2.0]),
}
MIXED = [("gaussian", 0.4, 0.25, 0.03), ("vonmises", 0.2, 0.7, 0.05),
         ("lorentzian2", 0.15, 0.9, [0.01, 0.03])]


def pair(spec):
    return R.make_template(spec), T.make_template(spec, device=CPU)


def close(got, want, rel=REL):
    """|got - want| within ``rel`` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= rel * scale, \
        np.max(np.abs(got - want)) / scale


@pytest.mark.parametrize("name", sorted(SPECS))
def test_primitive_matches_reference(name):
    r, t = pair([SPECS[name]])
    np.testing.assert_array_equal(t.theta, r.theta)       # pack
    close(t(PHASES), r(PHASES))
    for got, want in zip(t.unpack(t.theta), r.unpack(r.theta)):
        close(np.concatenate([np.atleast_1d(np.asarray(g)) for g in got])
              if isinstance(got, list) else got.numpy(),
              np.concatenate([np.atleast_1d(np.asarray(w)) for w in want])
              if isinstance(want, list) else np.asarray(want))
    close(t.fwhms(), r.fwhms())
    close(t.integrate(0.1, 0.8), r.integrate(0.1, 0.8))
    assert type(t.primitives[0]).__name__ == type(r.primitives[0]).__name__


@pytest.mark.parametrize("name", sorted(SPECS))
def test_random_matches_reference(name):
    """The same seed gives the reference's draws within 1e-12 and the
    same component choices."""
    r, t = pair([SPECS[name], ("gaussian", 0.2, 0.8, 0.05)])
    want = r.random(3000, rng=np.random.default_rng(7))
    got = t.random(3000, rng=np.random.default_rng(7))
    # the first draw of random is the component choice
    pc = [np.concatenate([[1 - x.norms.sum()], x.norms]) for x in (r, t)]
    comp = [np.random.default_rng(7).choice(3, size=3000, p=p) for p in pc]
    np.testing.assert_array_equal(comp[0], comp[1])
    d = np.abs(got - want)
    assert np.max(np.minimum(d, 1.0 - d)) <= 1e-12


def test_mixed_template_statistics():
    r, t = pair(MIXED)
    close(t(PHASES), r(PHASES))
    close(t.norms, r.norms)
    close(t.locs, r.locs)
    assert t.delta() == pytest.approx(r.delta(), abs=1e-15)
    assert t.Delta() == pytest.approx(r.Delta(), abs=1e-15)
    close(t.fwhms(), r.fwhms())
    for kw in ({}, {"free_norms": False}, {"prims": [1],
                                          "free_widths": False}):
        np.testing.assert_array_equal(t.param_mask(**kw),
                                      r.param_mask(**kw))
    r.rotate(0.4)
    t.rotate(0.4)
    close(t.theta, r.theta)
    close(t.integrate(0.0, 1.0), r.integrate(0.0, 1.0))
    assert str(t) == str(r)


def test_pdf_maps_over_theta_and_phases():
    """The pdf is a pure function: vmapped over a batch of thetas or of
    phase rows it gives each row's own evaluation."""
    _, t = pair(MIXED)
    pdf = t._pdf_fn()
    th = torch.as_tensor(t.theta) + torch.linspace(
        -0.01, 0.01, 5, dtype=torch.float64)[:, None]
    ph = torch.as_tensor(PHASES[:512]).reshape(4, 128)
    by_theta = torch.func.vmap(pdf, in_dims=(0, None))(th, ph[0])
    by_phase = torch.func.vmap(pdf, in_dims=(None, 0))(th[0], ph)
    for k in range(5):
        close(by_theta[k].numpy(), pdf(th[k], ph[0]).numpy(), 1e-15)
    for k in range(4):
        close(by_phase[k].numpy(), pdf(th[0], ph[k]).numpy(), 1e-15)


def test_template_files_cross_read(tmp_path):
    """A file either package writes reads back in the other to the
    theta its own reader gives."""
    r, t = pair(MIXED)
    rf, tf = tmp_path / "ref.txt", tmp_path / "port.txt"
    R.write_template(r, str(rf))
    T.write_template(t, str(tf))
    for path in (rf, tf):
        want = R.read_template(str(path))
        got = T.read_template(str(path), device=CPU)
        np.testing.assert_array_equal(got.theta, want.theta)
        assert [p.name for p in got.primitives] == \
            [p.name for p in want.primitives]
        close(got.theta, t.theta)


def test_gaussian_prior_nll():
    r, t = pair(MIXED)
    idx, means, sig = [4, 5, 7], [0.26, 0.69, 0.02], [1e-3, 2e-2, 0.5]
    theta = t.theta + 0.01
    got = float(T.GaussianPrior(idx, means, sig).nll(torch.as_tensor(theta)))
    want = float(R.GaussianPrior(idx, means, sig).nll(theta))
    assert got == pytest.approx(want, rel=REL)


def test_empirical_templates_match_reference():
    w = np.random.default_rng(3).uniform(size=PHASES.size)
    for args in ((PHASES,), (PHASES, w)):
        np.testing.assert_array_equal(
            T.LCEmpiricalFourier.from_phases(*args, nharm=12)(PHASES[:99]),
            R.LCEmpiricalFourier.from_phases(*args, nharm=12)(PHASES[:99]))
        np.testing.assert_array_equal(
            T.LCKernelDensity(*args)(PHASES[:99]),
            R.LCKernelDensity(*args)(PHASES[:99]))


def fit_pair(spec, truth_spec, n, seed):
    truth = R.make_template(truth_spec)
    rng = np.random.default_rng(seed)
    phases = truth.random(n, rng=rng)
    weights = rng.uniform(0.3, 1.0, n)
    r, t = pair(spec)
    return (R.LCFitter(r, phases, weights=weights),
            T.LCFitter(t, phases, weights=weights, device=CPU), r, t)


def hessian_errors(fitter, theta, free):
    """sqrt(diag(H^-1)) of the port's objective over the free entries
    with the background logit held (softmax's redundant direction; 0
    there and at fixed entries)."""
    keep = free.copy()
    keep[0] = False
    H = fitter._hess(torch.as_tensor(theta)).numpy()[np.ix_(keep, keep)]
    err = np.zeros(len(theta))
    err[keep] = np.sqrt(np.diag(np.linalg.inv(H)))
    return err


def gauged(theta, m):
    """theta with every logit taken relative to the background's: adding
    one number to all logits changes no norm."""
    t = np.array(theta)
    t[:m + 1] -= theta[0]
    return t


def assert_same_optimum(t, r, err, m):
    keep = err > 0
    d = np.abs(gauged(t.theta, m) - gauged(r.theta, m))
    assert np.all(d[keep] <= 1e-3 * err[keep]), d[keep] / err[keep]


@pytest.mark.parametrize("masked", [False, True])
def test_lcfitter_reaches_reference_optimum(masked):
    rfit, tfit, r, t = fit_pair(
        [("gaussian", 0.4, 0.33, 0.05), ("vonmises", 0.1, 0.75, 0.06)],
        [("gaussian", 0.5, 0.3, 0.03), ("vonmises", 0.15, 0.7, 0.05)],
        4096, 11)
    free = r.param_mask(prims=[0]) if masked else None
    want = rfit.fit(free=free)
    got = tfit.fit(free=free)
    assert got["success"] and want["success"]
    assert got["loglikelihood"] == pytest.approx(want["loglikelihood"],
                                                 rel=1e-9)
    fr = np.ones(len(t.theta), bool) if free is None else free
    assert_same_optimum(t, r, hessian_errors(tfit, t.theta, fr), 2)
    assert np.all(t.theta[~fr] == r.theta[~fr])
    # the errors of the identifiable entries (locs and widths)
    ident = fr.copy()
    ident[:3] = False
    np.testing.assert_allclose(got["theta_err"][ident],
                               want["theta_err"][ident], rtol=1e-6)
    assert tfit.loglikelihood() == pytest.approx(rfit.loglikelihood(),
                                                 rel=1e-12)


def test_fit_binned_reaches_reference_optimum():
    rfit, tfit, r, t = fit_pair([("gaussian", 0.5, 0.5, 0.07)],
                                [("gaussian", 0.7, 0.55, 0.04)], 4096, 12)
    want = rfit.fit_binned(nbins=64)
    got = tfit.fit_binned(nbins=64)
    assert got["success"] and want["success"]
    assert got["chi2"] == pytest.approx(want["chi2"], rel=1e-9)
    assert_same_optimum(
        t, r, hessian_errors(tfit, t.theta, np.ones(len(t.theta), bool)), 1)


def test_entry_points_default_to_cuda():
    """device=None means the GPU: without one, construction raises
    instead of running on the CPU."""
    spec = [("gaussian", 0.5, 0.3, 0.03)]
    if torch.cuda.is_available():
        assert T.make_template(spec).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_template(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.LCFitter(T.make_template(spec, device=CPU), PHASES)
