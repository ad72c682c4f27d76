"""The port's energy-dependent templates (pint_tpu_torch.templates.energy)
against the reference (pint_tpu.templates.energy) on the CPU: the pdf,
the draws (chunked and not), the base template and LCEnergyFitter."""

import numpy as np
import pytest
import torch

import pint_tpu.templates as R
import pint_tpu.templates.energy as RE
import pint_tpu_torch.templates as T
import pint_tpu_torch.templates.energy as TE
from pint_tpu_torch import config

CPU = "cpu"
BASE = [("gaussian", 0.45, 0.3, 0.04), ("vonmises", 0.2, 0.7, 0.05),
        ("lorentzian", 0.1, 0.9, 0.02)]
SLOPES = dict(e0_kev=1.0, dlogits=[0.0, 0.4, -0.2, 0.1],
              dloc=[0.05, -0.02, 0.01], dlogw=[0.3, 0.0, -0.1])
RNG = np.random.default_rng(21)
PHASES = RNG.uniform(size=4096)
ENERGIES = 10.0 ** RNG.uniform(-1, 1, 4096)   # 0.1-10 keV


def pair(spec=BASE, **kw):
    return (RE.LCEnergyTemplate(R.make_template(spec), **kw),
            TE.LCEnergyTemplate(T.make_template(spec, device=CPU),
                                device=CPU, **kw))


def test_pdf_matches_reference():
    r, t = pair(**SLOPES)
    np.testing.assert_array_equal(t.theta, r.theta)
    want = r(PHASES, ENERGIES)
    assert np.max(np.abs(t(PHASES, ENERGIES) - want)) \
        <= 1e-13 * np.max(want)
    grid = np.linspace(0, 1, 257)
    np.testing.assert_allclose(t.base_template()(grid),
                               r.base_template()(grid), rtol=1e-13)
    assert str(t) == str(r)


def test_random_matches_reference():
    """Every draw within one grid cell (1/2048) of the reference's, and
    at least 99.9 % equal."""
    r, t = pair(**SLOPES)
    n = 3000
    want = r.random(n, ENERGIES[:n], rng=np.random.default_rng(5))
    got = t.random(n, ENERGIES[:n], rng=np.random.default_rng(5))
    assert np.max(np.abs(got - want)) <= 1.0 / 2048 + 1e-15
    assert np.mean(got == want) >= 0.999


def test_random_chunks_do_not_change_draws(monkeypatch):
    _, t = pair(**SLOPES)
    n = 600
    whole = t.random(n, ENERGIES[:n], rng=np.random.default_rng(9))
    monkeypatch.setattr(config, "energy_draw_chunk", lambda ngrid: 7)
    chunked = t.random(n, ENERGIES[:n], rng=np.random.default_rng(9))
    np.testing.assert_array_equal(chunked, whole)
    with pytest.raises(ValueError, match="energies_kev"):
        t.random(5, ENERGIES[:4])


def test_energy_fitter_reaches_reference_optimum():
    truth = RE.LCEnergyTemplate(R.make_template([BASE[0]]), e0_kev=1.0,
                                dloc=[0.08], dlogw=[0.2])
    n = 4096
    rng = np.random.default_rng(31)
    phases = truth.random(n, ENERGIES[:n], rng=rng)
    weights = rng.uniform(0.5, 1.0, n)
    r, t = pair([("gaussian", 0.5, 0.33, 0.05)], e0_kev=1.0)
    rfit = RE.LCEnergyFitter(r, phases, ENERGIES[:n], weights=weights)
    tfit = TE.LCEnergyFitter(t, phases, ENERGIES[:n], weights=weights,
                             device=CPU)
    want, got = rfit.fit(), tfit.fit()
    assert got["success"] and want["success"]
    assert got["loglikelihood"] == pytest.approx(want["loglikelihood"],
                                                 rel=1e-9)
    # errors from the exact Hessian with the two softmax-redundant
    # background entries (logit and its slope) held; every logit and
    # slope compared relative to the background's
    m = 1
    keep = np.ones(len(t.theta), bool)
    keep[[0, 3 * m + 1]] = False
    H = torch.func.hessian(tfit._nll)(torch.as_tensor(t.theta)).numpy()
    err = np.sqrt(np.diag(np.linalg.inv(H[np.ix_(keep, keep)])))

    def gauged(theta):
        g = np.array(theta)
        g[:m + 1] -= theta[0]
        g[3 * m + 1:4 * m + 2] -= theta[3 * m + 1]
        return g[keep]

    assert np.all(np.abs(gauged(t.theta) - gauged(r.theta)) <= 1e-3 * err)
    assert tfit.loglikelihood() == pytest.approx(rfit.loglikelihood(),
                                                 rel=1e-12)


def test_rejects_multishape_primitives():
    t = T.make_template([("gaussian2", 0.5, 0.4, [0.02, 0.05])],
                        device=CPU)
    with pytest.raises(ValueError):
        TE.LCEnergyTemplate(t, device=CPU)
    with pytest.raises(ValueError, match="dloc"):
        TE.LCEnergyTemplate(T.make_template([BASE[0]], device=CPU),
                            dloc=[0.1, 0.2], device=CPU)
