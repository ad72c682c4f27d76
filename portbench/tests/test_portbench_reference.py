"""The GWB reference against the dense N x N likelihood of a few pulsars,
and the port against the reference on the CPU."""

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.tests.conftest import small_gwb, small_msp

REF = registry.module("reference", "ng15-gwb67")
SYS = registry.module("systems", "gwb_array")


def dense_loglik(inputs, log10_A, gamma):
    """log L of the whole array from its dense covariance C = N + F phi F^T
    + U (Gamma (x) phi_g) U^T, the timing models marginalized under a flat
    prior: -1/2 [r^T C^-1 r - b^T (M^T C^-1 M)^-1 b + logdet C
    + logdet M^T C^-1 M], b = M^T C^-1 r."""
    P = len(inputs["M"])
    ts, tspan = REF.epoch_seconds(inputs)
    n = [len(t) for t in ts]
    off = np.concatenate([[0], np.cumsum(n)])
    N = off[-1]
    C = np.zeros((N, N))
    Ms = np.zeros((N, sum(M.shape[1] for M in inputs["M"])))
    Us = []
    col = 0
    for a in range(P):
        sl = slice(off[a], off[a + 1])
        F, phi = inputs["F"][a], inputs["phi"][a]
        C[sl, sl] = np.diag(inputs["nvec"][a]) + (F * phi) @ F.T
        p = inputs["M"][a].shape[1]
        Ms[sl, col:col + p] = inputs["M"][a]
        col += p
        U, f = REF.fourier_basis(torch.as_tensor(ts[a]), inputs["nfreq"],
                                 tspan)
        Us.append(U.numpy())
    G = REF.hellings_downs(torch.as_tensor(inputs["positions"])).numpy()
    phig = REF.powerlaw_weights(f, log10_A, gamma, tspan).numpy()
    for a in range(P):
        for b in range(P):
            C[off[a]:off[a + 1], off[b]:off[b + 1]] += \
                G[a, b] * (Us[a] * phig) @ Us[b].T
    r = np.concatenate(inputs["r"])
    Ci = np.linalg.inv(C)
    MCM = Ms.T @ Ci @ Ms
    b = Ms.T @ Ci @ r
    return -0.5 * (r @ Ci @ r - b @ np.linalg.solve(MCM, b)
                   + np.linalg.slogdet(C)[1] + np.linalg.slogdet(MCM)[1])


@pytest.fixture(scope="module")
def trio():
    cfg = dict(registry.config("ng15-gwb67"), **small_gwb(3, 2))
    cfg["assumed"]["toas"] = [160, 192, 144]
    cfg["assumed"]["cadence_days"] = [30, 21, 40]
    cfg["assumed"]["design_columns"] = [10, 11, 10]
    return SYS.make_inputs(cfg, 20240601, torch.device("cpu"))


@pytest.mark.parametrize("point", [(-14.62, 13 / 3), (-15.3, 2.5),
                                   (-13.8, 5.5)])
def test_reference_is_the_dense_likelihood(trio, point):
    want = dense_loglik(trio, *point)
    got = REF.loglik(REF.prepare(trio, torch.device("cpu")),
                     np.array([point[0]]), np.array([point[1]]))[0]
    assert abs(got - want) <= 1e-9 * abs(want)


def test_hellings_downs_values():
    pos = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0]],
                       dtype=torch.float64)
    G = REF.hellings_downs(pos).numpy()
    x = 0.5  # 90 degrees
    assert G[0, 1] == pytest.approx(1.5 * x * np.log(x) - x / 4 + 0.5)
    assert G[0, 2] == pytest.approx(1.5 * np.log(1.0) - 0.25 + 0.5)
    assert np.all(np.diag(G) == 1.0)


def test_port_matches_reference_on_the_cpu(small):
    cfg = dict(registry.config("ng15-gwb67"), **small)
    s = SYS.build(cfg, 77, torch.device("cpu"))
    la = np.array([-14.9, -14.2, -13.6])
    ga = np.array([3.1, 4.4, 5.9])
    got = s.like.loglik_grid(la, ga)
    want = REF.loglik(REF.prepare(s.inputs, torch.device("cpu")), la, ga)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_sizes_do_not_depend_on_the_seed(small):
    cfg = dict(registry.config("ng15-gwb67"), **small)
    a = SYS.make_inputs(cfg, 1, torch.device("cpu"))
    b = SYS.make_inputs(cfg, 2 ** 31 + 11, torch.device("cpu"))
    for k in ("M", "F", "r", "nvec", "mjd_day"):
        assert [x.shape for x in a[k]] == [x.shape for x in b[k]]
    assert not np.array_equal(a["r"][0], b["r"][0])
    c = SYS.make_inputs(cfg, 1, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a["r"], c["r"]))


MSP_REF = registry.module("reference", "ng-msp-10k")
MSP = registry.module("systems", "msp_fit")


@pytest.fixture(scope="module")
def msp():
    cfg = dict(registry.config("ng-msp-10k"), **small_msp())
    return cfg, MSP.build(cfg, 20240601, torch.device("cpu"))


def test_msp_residuals_are_the_ports(msp):
    """At the par file's values the reference's residuals are the port's
    CPU path's, to the reference's float64 phase (~1e-11 s)."""
    from pint_tpu_torch.residuals import Residuals

    cfg, s = msp
    got = np.asarray(Residuals(s.toas, s.model).time_resids)
    m = MSP_REF.Model(cfg, s.inputs, torch.device("cpu"), torch.float64)
    want = m.residuals(m.p0(), m.f0, m.f1).numpy()
    assert np.max(np.abs(got - want)) <= 1e-10
    # the simulated TOAs carry their noise, not whole pulses
    assert 1e-7 < np.std(want) < 1e-5


@pytest.mark.parametrize("off", [(0.0, 0.0), (-3.5, 2.0), (3.0, -3.5)])
def test_msp_refit_chi2_is_the_ports(msp, off):
    """The refit chi2 at a node, the port's grid_chisq on the CPU at 400
    TOAs against the reference."""
    from pint_tpu_torch.gridutils import grid_chisq

    cfg, s = msp
    mix = registry.traffic("msp-grid16")
    node = [c + o * sg for c, o, sg in zip(mix["centre"], off,
                                            mix["sigma"])]
    got = grid_chisq(s.model, s.toas, ("F0", "F1"),
                     ([node[0]], [node[1]]), maxiter=cfg["maxiter"])[0, 0]
    want = MSP_REF.grid_chi2(s.inputs, cfg, np.array([node]),
                             torch.device("cpu"))[0]
    assert abs(got - want) <= 1e-2 * cfg["limits"]["chi2_gap"]


def test_msp_refit_without_steps_is_the_dense_chi2(msp):
    """With no refit step the reference's chi2 is r^T C^-1 r of the
    mean-subtracted residuals, C built densely in numpy."""
    cfg, s = msp
    m = MSP_REF.Model(cfg, s.inputs, torch.device("cpu"), torch.float64)
    r = m.residuals(m.p0(), m.f0, m.f1).numpy()
    eid = m.eid.numpy()
    C = np.diag(m.nvec.numpy()) + m.ecorr_var * (eid[:, None]
                                                 == eid[None, :])
    F, phi = m.F.numpy(), m.phi.numpy()
    C = C + (F * phi) @ F.T
    want = r @ np.linalg.solve(C, r)
    got = float(m.node_chi2(m.f0, m.f1, 0))
    assert abs(got - want) <= 1e-8 * want


def test_msp_sizes_do_not_depend_on_the_seed():
    cfg = dict(registry.config("ng-msp-10k"), **small_msp())
    a = MSP_REF.simulate(cfg, 1, torch.device("cpu"))
    b = MSP_REF.simulate(cfg, 2 ** 31 + 11, torch.device("cpu"))
    c = MSP_REF.simulate(cfg, 1, torch.device("cpu"))
    for k in ("tdb_day", "ssb_obs_pos", "freq_mhz", "error_us"):
        assert a[k].shape == b[k].shape
    assert not np.array_equal(a["tdb_frac_hi"], b["tdb_frac_hi"])
    assert np.array_equal(a["tdb_frac_hi"], c["tdb_frac_hi"])


def test_msp_grid_scale_is_the_fits(msp):
    """The traffic file's grid scale (F0 and F1 standard errors read once
    at 10,000 TOAs) is the reference fit's at the CPU size to within a
    factor of two: red noise, not the TOA count, sets it."""
    cfg, s = msp
    got = MSP_REF.spin_sigma(s.inputs, cfg, torch.device("cpu"))
    want = np.asarray(registry.traffic("msp-grid16")["sigma"])
    assert np.all((0.5 < got / want) & (got / want < 2.0))
