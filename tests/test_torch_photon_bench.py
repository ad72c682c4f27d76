"""The NICER J0030+0451 photon deployment (the benchmark's configuration
``nicer-j0030-photon``) on the port's normal path, on the CPU at 4,096
photons and 8 walkers, inputs from a seed: ``PhotonMCMCFitter``'s walker
log-likelihoods and the H-test against the benchmark's plain reference,
the float32 control, the ``photon.lnlike`` / ``photon.htest`` spans and
the fitter's counters, ``scan`` against ``host_loop`` with the spans
on, a chain continued from its log-likelihoods, and the cell through
``portbench.run``."""

import copy

import numpy as np
import pytest
import torch

from pint_tpu_torch import config, obs
from pint_tpu_torch.runtime import reset_runtime
from pint_tpu_torch.sampling import DeviceEnsembleSampler

from portbench import registry, run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
PHOTONS = 4096
WALKERS = 8
CFG = registry.config("nicer-j0030-photon")
REF = registry.module("reference", "nicer-j0030-photon")
SYS = registry.module("systems", "photon_chain")
# the port's phase is double-double and the reference's float64 with an
# exact F0 product: at 4,096 photons their log L differ by ~1e-11 nats
# (sums in another order), and a float32 reference by ~300 nats
LNL_TOL = 1e-8
# on the CPU both H-tests sum float64 terms: ~1e-14 relative apart; the
# float32 reference's phases lose the pulse (H ~ 1 against ~330)
H_REL = 1e-10


def small_cfg(photons=PHOTONS):
    a = copy.deepcopy(CFG["assumed"])
    a["photons"] = photons
    return dict(CFG, assumed=a)


@pytest.fixture(autouse=True)
def clean():
    reset_runtime()
    obs.reset()
    yield
    reset_runtime()
    obs.reset()


@pytest.fixture(scope="module")
def system():
    return SYS.build(small_cfg(), SEED, CPU)


def walkers(system, n=WALKERS, seed=5, scale=3.0):
    rng = np.random.default_rng(seed)
    return system.fitter.theta0[None, :] + scale * system.sigma[None, :] \
        * rng.standard_normal((n, 2))


def test_walker_lnlike_matches_reference(system):
    th = walkers(system)
    got = system.fitter.lnpost_batch(torch.as_tensor(th)).numpy()
    want = REF.lnlike(system.inputs, small_cfg(), th, CPU)
    assert np.ptp(want) > 1.0
    assert np.max(np.abs(got - want)) <= LNL_TOL


def test_htest_matches_reference(system):
    th = walkers(system, n=2, seed=6)
    got = np.array([system.htest(t) for t in th])
    want = REF.htest(system.inputs, small_cfg(), th, CPU)
    assert np.all(want > 100.0)
    assert np.max(np.abs(got - want) / want) <= H_REL


def test_float32_control_exceeds_the_tolerances(system):
    th = walkers(system, n=4, seed=7)
    cfg = small_cfg()
    lo = REF.lnlike(system.inputs, cfg, th, CPU, torch.float32)
    hi = REF.lnlike(system.inputs, cfg, th, CPU)
    assert np.max(np.abs(lo - hi)) > 1e3 * LNL_TOL
    h_lo = REF.htest(system.inputs, cfg, th[:1], CPU, torch.float32)
    h_hi = REF.htest(system.inputs, cfg, th[:1], CPU)
    assert abs(h_lo[0] - h_hi[0]) / h_hi[0] > 1e3 * H_REL


def test_spans_record_with_their_attributes(system):
    tr = obs.configure(enabled=True)
    system.fitter.lnpost_batch(torch.as_tensor(walkers(system)))
    system.htest(walkers(system, n=1)[0])
    recs = tr.records()
    ln = [r for r in recs if r["name"] == "photon.lnlike"]
    ht = [r for r in recs if r["name"] == "photon.htest"]
    assert len(ln) == 1 and len(ht) == 1
    assert {k: ln[0]["args"][k] for k in ("walkers", "photons", "chunk")} \
        == {"walkers": WALKERS, "photons": PHOTONS, "chunk": 0}
    assert {k: ht[0]["args"][k] for k in ("m", "photons")} == \
        {"m": 20, "photons": PHOTONS}


def test_spans_cost_nothing_when_off(system):
    """Off, a span is the shared no-op: the ring stays empty."""
    tr = obs.configure(enabled=False)
    system.fitter.lnpost_batch(torch.as_tensor(walkers(system)))
    assert not [r for r in tr.records() if r["name"].startswith("photon.")]


@pytest.mark.parametrize("chunk", [None, 2, 3])
def test_counters_count_a_known_chain(chunk, monkeypatch):
    """walker_evals counts every walker log-likelihood, lnlike_batches
    every vmapped chunk: the starting ensemble, then two half-ensembles a
    step, each cut into chunks of ``photon_walker_chunk`` walkers."""
    if chunk is not None:
        monkeypatch.setattr(config, "photon_walker_chunk", lambda n: chunk)
    s = SYS.build(small_cfg(1024), SEED, CPU)
    f = s.fitter
    sampler = DeviceEnsembleSampler(WALKERS, 2, f.lnpost_batch, device=CPU)
    before = f.metrics.snapshot()
    sampler.run_mcmc(walkers(s), 3, seed=9, mode="scan")
    after = f.metrics.snapshot()
    k = chunk or WALKERS
    half = WALKERS // 2
    per_half = -(-half // k)
    assert after["walker_evals"] - before["walker_evals"] == \
        WALKERS + 3 * 2 * half
    assert after["lnlike_batches"] - before["lnlike_batches"] == \
        -(-WALKERS // k) + 3 * 2 * per_half
    assert s.counters() == after


def test_scan_and_host_loop_stay_bitwise_with_spans_on(system):
    obs.configure(enabled=True)
    f = system.fitter
    p0 = walkers(system, seed=11, scale=1.0)
    out = []
    for mode in ("scan", "host_loop"):
        s = DeviceEnsembleSampler(WALKERS, 2, f.lnpost_batch, device=CPU)
        pos = s.run_mcmc(p0, 4, seed=13, mode=mode)
        out.append((pos, s.chain, s.lnprob, s.naccepted))
    (pa, ca, la, na), (pb, cb, lb, nb) = out
    assert np.array_equal(pa, pb) and np.array_equal(ca, cb)
    assert np.array_equal(la, lb) and na == nb


def test_a_chain_continues_from_its_log_likelihoods(system):
    """Given the starting log-likelihoods, the chain is the same bit for
    bit and evaluates no starting ensemble."""
    f = system.fitter
    p0 = walkers(system, seed=12, scale=1.0)
    a = DeviceEnsembleSampler(WALKERS, 2, f.lnpost_batch, device=CPU)
    pa = a.run_mcmc(p0, 2, seed=3)
    lp0 = f.lnpost_batch(torch.as_tensor(p0)).numpy()
    b = DeviceEnsembleSampler(WALKERS, 2, f.lnpost_batch, device=CPU)
    before = f.metrics.snapshot()["walker_evals"]
    pb = b.run_mcmc(p0, 2, seed=3, lp0=lp0)
    assert f.metrics.snapshot()["walker_evals"] - before == 2 * WALKERS
    assert np.array_equal(pa, pb) and np.array_equal(a.lnprob, b.lnprob)
    with pytest.raises(ValueError):
        b.run_mcmc(p0, 2, seed=3, lp0=lp0[:-1])


def test_barycentred_unweighted_photons_load(system):
    """TOAs.from_npz takes the events at the barycentre with no weights
    column: no weights, every TOA at the barycentre, the observatory at
    the origin, the Sun's position as given."""
    t = system.toas
    assert t.ntoas == PHOTONS and t.weights is None
    assert set(t.obs) == {"barycenter"}
    assert not np.any(t.ssb_obs_pos)
    assert np.array_equal(t.obs_sun_pos, system.inputs["obs_sun_pos"])
    assert np.array_equal(t.tdb_frac[1], system.inputs["tdb_frac_lo"])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_through_the_benchmark(trace):
    spec = registry.load_spec()
    cell = registry.cell(spec, "nicer-j0030-chain")
    a = small_cfg(2048)["assumed"]
    out = run.run_cell(spec, cell, 2 ** 40 + 3, 0.2, bool(trace), CPU,
                       {"assumed": a, "check_points": 6},
                       {"nwalkers": WALKERS, "steps": 2})
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % (2 * WALKERS) == 0 and out["attempted"] > 0
    gaps = out["compared"]
    assert set(gaps) == {"lnlike_gap", "htest_gap"}
    assert all(g["value"] is not None and g["value"] <= g["limit"]
               for g in gaps.values())
