"""The matrix-free streaming GLS of the port (pint_tpu_torch.parallel.
streaming, StreamingGLSFitter, Fitter.auto's streaming route and the
config parsers) against the reference pint_tpu on the CPU, on
tests/test_streaming_gls.py's J1744-1134-like model (EFAC/EQUAD, 8
red-noise modes; its ECORR variant on clustered four-TOA epochs) and
recipe for the TOAs.

The accumulator is held to the reference's run eagerly
(``jax.disable_jit()``: compiled, XLA rounds some delays 1 ulp away from
the eager chain, which moves dparams ~4e-8 sigma): every array of the
accumulated state within 1e-12 of its largest entry, dparams within
1e-9 sigma and chi2 within 1e-10 relative. The port's own oracles are
tests/test_streaming_gls.py:105-208's, at their limits: the dense step
(Cholesky), chunk-size invariance, the ECORR boundary carry and the
numpy mirror. The reference's f32 routes are not ported (ROADMAP.md item
1b). The failover to the numpy mirror is held in
tests/test_torch_runtime_faults.py."""

import copy
import io
import warnings

import jax
import numpy as np
import pytest

from pint_tpu.parallel.streaming import StreamingGLS as RStreamingGLS

from pint_tpu_torch import config
from pint_tpu_torch.fitter import Fitter
from pint_tpu_torch.gls import DownhillGLSFitter, NonFiniteStepError, \
    StreamingGLSFitter
from pint_tpu_torch.models import get_model
from pint_tpu_torch.models.convert import toas_from_columns
from pint_tpu_torch.parallel import build_fit_step
from pint_tpu_torch.parallel.streaming import StreamingGLS

from test_streaming_gls import PAR, PAR_ECORR, _mk

CPU = "cpu"
STATE_REL, DP_SIGMA, CHI2_REL = 1e-12, 1e-9, 1e-10   # against the reference

_BUILT: dict = {}


def _problem(ecorr=False, n=600):
    """(reference model, reference TOAs, port model, port TOAs); the ECORR
    variant on clustered epochs. The models are deep copies."""
    key = (ecorr, n)
    if key not in _BUILT:
        par = PAR_ECORR if ecorr else PAR
        rm, rt = _mk(par, n=n, clustered=ecorr)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tm = get_model(io.StringIO(par), device=CPU)
        _BUILT[key] = (rm, rt, tm, toas_from_columns(rt, CPU))
    rm, rt, tm, tt = _BUILT[key]
    return copy.deepcopy(rm), rt, copy.deepcopy(tm), tt


def _dense(model, toas):
    step, args, names = build_fit_step(model, toas)
    dp, cov, chi2, _ = (x.numpy() for x in step(*args))
    return dp, cov, float(chi2), names


def _stream(model, toas, chunk):
    sg = StreamingGLS(model, toas, chunk=chunk)
    return sg, sg.solve(sg.accumulate(sg.th0, sg.tl0))


@pytest.mark.parametrize("ecorr", [False, True], ids=["red", "ecorr"])
def test_accumulator_and_finalize_match_reference(ecorr):
    """One pass at chunk 66 (every chunk boundary mid-epoch on the
    clustered fixture), port against the eager reference: the state
    (column max, Gram, cross and moment terms, ECORR carry) and the CG
    solve."""
    rm, rt, tm, tt = _problem(ecorr, n=200)
    sg, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, tt, 66)
    state = [x.numpy() for x in sg.accumulate(sg.th0, sg.tl0)]
    rsg = RStreamingGLS(rm, rt, chunk=66, anchored=False, jac_f32=False,
                        matmul_f32=False)
    assert sg.names == rsg.names and sg.nchunks == rsg.nchunks
    assert sg.default_budget == rsg.default_budget
    with jax.disable_jit():
        rstate = rsg.accumulate(rsg.th0, rsg.tl0)
    for i, (a, b) in enumerate(zip(state, rstate)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        assert np.max(np.abs(a - b)) <= STATE_REL * max(np.max(np.abs(b)),
                                                        1e-300), i
    rdp, rcov, rchi2, rchi2r, rxf, rok, riters, _ = rsg.solve(rstate)
    # the stop test (relative residual 1e-13) may fall one iteration
    # apart under the two libraries' summation orders
    assert ok and rok and abs(iters - riters) <= 1
    sig = np.sqrt(np.diag(rcov))
    assert np.max(np.abs(dp - rdp) / sig) <= DP_SIGMA
    assert np.max(np.abs(cov - rcov) / np.outer(sig, sig)) <= DP_SIGMA
    assert chi2r == pytest.approx(rchi2r, rel=CHI2_REL)
    assert chi2 == pytest.approx(rchi2, rel=CHI2_REL)
    assert np.allclose(xf, rxf, rtol=1e-8, atol=1e-8 * np.max(np.abs(rxf)))


def test_cg_matches_dense_cholesky():
    """tests/test_streaming_gls.py:105: the CG solution equals the dense
    step's Cholesky (dparams and covariance 1e-8 sigma, chi2 1e-9
    relative), within the CG budget."""
    _, _, tm, tt = _problem()
    dpD, covD, chi2D, names = _dense(tm, tt)
    sig = np.sqrt(np.abs(np.diag(covD)))
    sg, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, tt, 128)
    assert ok and sg.names == names
    assert iters <= 8 * (len(names) + 1)
    assert resid <= 1e-13 ** 0.5
    assert np.max(np.abs(dp - dpD) / sig) < 1e-8
    assert abs(chi2r - chi2D) < 1e-9 * abs(chi2D)
    assert np.max(np.abs(cov - covD) / np.outer(sig, sig)) < 1e-8


def test_chunk_size_invariance():
    """tests/test_streaming_gls.py:121: the same answer at every chunk
    length, one that does not divide N (a padded last chunk) included:
    dparams 1e-9 sigma, chi2 1e-10 relative."""
    _, _, tm, tt = _problem()
    results = {}
    for chunk in (64, 100, 256, 1024):
        _, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, tt,
                                                                  chunk)
        assert ok, chunk
        results[chunk] = (dp, chi2r)
    ref_dp, ref_chi = results[1024]
    sig = np.sqrt(np.abs(np.diag(cov)))
    for chunk, (dp, chi) in results.items():
        assert np.max(np.abs(dp - ref_dp) / sig) < 1e-9, chunk
        assert abs(chi - ref_chi) < 1e-10 * abs(ref_chi), chunk


def test_ecorr_boundary_carry():
    """tests/test_streaming_gls.py:139: ECORR epochs split by chunk
    boundaries are downdated exactly (the boundary carry): chunks of 66
    (every boundary mid-epoch) and 128 against the dense step (dparams
    1e-8 sigma, chi2 1e-9 relative); and with the TOAs out of epoch
    order, which the accumulator sorts."""
    _, rt, tm, tt = _problem(ecorr=True, n=400)
    dpD, covD, chi2D, _ = _dense(tm, tt)
    sig = np.sqrt(np.abs(np.diag(covD)))
    for chunk in (66, 128):
        sg, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, tt,
                                                                   chunk)
        assert ok and sg._perm is None
        assert np.max(np.abs(dp - dpD) / sig) < 1e-8, chunk
        assert abs(chi2r - chi2D) < 1e-9 * abs(chi2D), chunk
    # reversed TOAs: the epoch sort (and its undoing for the noise)
    rev = toas_from_columns(rt.select(np.arange(rt.ntoas)[::-1]), CPU)
    sg, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, rev, 66)
    assert ok and sg._perm is not None
    assert np.max(np.abs(dp - dpD) / sig) < 1e-8
    assert abs(chi2r - chi2D) < 1e-9 * abs(chi2D)
    sg_fwd, fwd = _stream(tm, tt, 66)
    noise = sg_fwd.noise_realization(fwd[4])
    assert np.max(np.abs(sg.noise_realization(xf)[::-1] - noise)) <= \
        1e-8 * np.max(np.abs(noise))


def test_numpy_mirror_matches_device():
    """tests/test_streaming_gls.py:155: the numpy mirror (dense host rows,
    chunked numpy accumulate, numpy CG) reproduces the torch pass
    (dparams 1e-7 sigma, chi2 1e-8 relative)."""
    _, _, tm, tt = _problem(ecorr=True, n=400)
    sg, (dp, cov, chi2, chi2r, xf, ok, iters, resid) = _stream(tm, tt, 128)
    dpn, covn, chin, chirn, xfn, okn, _, _ = sg.solve_np()
    assert okn
    sig = np.sqrt(np.abs(np.diag(cov)))
    assert np.max(np.abs(dpn - dp) / sig) < 1e-7
    assert abs(chirn - chi2r) < 1e-8 * abs(chi2r)


@pytest.mark.parametrize("ecorr", [False, True], ids=["red", "ecorr"])
def test_streaming_fitter_matches_downhill(ecorr):
    """tests/test_streaming_gls.py:186: StreamingGLSFitter reaches
    DownhillGLSFitter's fit (chi2 1e-6 relative, parameters 1e-4 sigma),
    in at least two passes, with the noise realization in TOA order (the
    red-noise fixture's held to the host fitter's within 1e-3 of its
    largest value; the host fitter's realization of the ECORR fixture
    also holds ECORR's own basis, which the streaming path takes as
    segment downdates)."""
    _, _, m1, tt = _problem(ecorr, n=400 if ecorr else 600)
    m2 = copy.deepcopy(m1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f1 = DownhillGLSFitter(tt, m1)
        c1 = f1.fit_toas(maxiter=10)
    f2 = StreamingGLSFitter(tt, m2, chunk=128)
    c2 = f2.fit_toas(maxiter=10)
    assert abs(c1 - c2) < 1e-6 * abs(c1)
    for n in m1.free_params:
        e = m1.get_param(n).uncertainty or 1.0
        assert abs(m1.get_param(n).value
                   - m2.get_param(n).value) / e < 1e-4, n
    assert f2.passes >= 2 and len(f2.cg_iters_per_pass) == f2.passes
    assert f2.stats is not None and f2.stats.converged
    assert f2.cg_budget == 8 * (len(m2.free_params) + 2)
    noise = f2.get_noise_resids()
    ref_noise = f1.get_noise_resids().numpy()
    assert noise.shape == (tt.ntoas,)
    if not ecorr:
        assert np.max(np.abs(noise - ref_noise)) < 1e-3 * np.max(
            np.abs(ref_noise))


def test_failed_first_pass_raises():
    """A CG solve that cannot meet its tolerance (0 here) on the first
    pass raises NonFiniteStepError: the streaming path has no SVD
    fallback."""
    _, _, tm, tt = _problem(n=200)
    with pytest.raises(NonFiniteStepError, match="streaming CG"):
        StreamingGLSFitter(tt, tm, chunk=128).fit_toas(cg_tol=0.0)


def test_fitter_auto_routing(monkeypatch):
    """tests/test_streaming_gls.py:208: Fitter.auto streams from the
    threshold on, 0 turns the route off, streaming=False/True override,
    device=True wins over the automatic route; wideband TOAs with
    streaming=True raise ValueError."""
    _, rt, tm, tt = _problem()
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "500")
    f = Fitter.auto(tt, copy.deepcopy(tm))
    assert isinstance(f, StreamingGLSFitter) and f.device.type == CPU
    from pint_tpu_torch.gls import DeviceDownhillGLSFitter

    assert type(Fitter.auto(tt, tm, device=True)) is DeviceDownhillGLSFitter
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", str(tt.ntoas + 1))
    assert type(Fitter.auto(tt, tm)) is DownhillGLSFitter
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "0")
    assert type(Fitter.auto(tt, tm)) is DownhillGLSFitter
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "500")
    assert type(Fitter.auto(tt, tm, streaming=False)) is DownhillGLSFitter
    monkeypatch.delenv("PINT_TPU_STREAM_MIN_TOA", raising=False)
    assert isinstance(Fitter.auto(tt, tm, streaming=True, chunk=256),
                      StreamingGLSFitter)
    wb = copy.deepcopy(rt)
    for fl in wb.flags:
        fl["pp_dm"], fl["pp_dme"] = "3.14", "1e-4"
    twb = toas_from_columns(wb, CPU)
    with pytest.raises(ValueError, match="cannot fit wideband"):
        Fitter.auto(twb, tm, streaming=True)
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "500")
    assert type(Fitter.auto(twb, tm)).__name__ == "WidebandDownhillFitter"
    with pytest.raises(ValueError, match="wideband"):
        StreamingGLS(tm, tt, wideband=True)


def test_config_parsers_validated(monkeypatch):
    """tests/test_streaming_gls.py:227: the reference's defaults, and a
    bad value warns and gives the default; a set chunk is rounded up to
    a power of two."""
    monkeypatch.delenv("PINT_TPU_STREAM_CHUNK", raising=False)
    monkeypatch.delenv("PINT_TPU_STREAM_MIN_TOA", raising=False)
    assert config.solve_streaming() == 200_000
    assert config.stream_chunk(100_000) == 16384
    assert config.stream_chunk(200_000) == 32768
    assert config.stream_chunk(1_000_000) == 65536
    assert config.stream_chunk(1000) == 4096
    monkeypatch.setenv("PINT_TPU_STREAM_CHUNK", "3000")
    assert config.stream_chunk(10_000) == 4096
    monkeypatch.setenv("PINT_TPU_STREAM_CHUNK", "100")
    assert config.stream_chunk(10_000) == 256
    monkeypatch.setenv("PINT_TPU_STREAM_CHUNK", "1000000")
    assert config.stream_chunk(10_000) == 131072
    monkeypatch.setenv("PINT_TPU_STREAM_CHUNK", "bogus")
    assert config.stream_chunk(100_000) == 16384
    monkeypatch.setenv("PINT_TPU_STREAM_CHUNK", "-5")
    assert config.stream_chunk(100_000) == 16384
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "nope")
    assert config.solve_streaming() == 200_000
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "-1")
    assert config.solve_streaming() == 200_000
    monkeypatch.setenv("PINT_TPU_STREAM_MIN_TOA", "12345")
    assert config.solve_streaming() == 12345
