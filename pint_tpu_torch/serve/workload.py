"""The ONE synthetic mixed-shape serve workload builder (a port of
pint_tpu/serve/workload.py: the same pulsars, TOAs and request mix,
built with the port's models on ``device``, the GPU by default).

Used by both ``bench_serve.py`` (sequential-vs-coalesced throughput
artifact) and ``scripts/pint_serve.py --demo`` (the daemon demo) —
previously two near-identical copies that could drift apart, flagged
in review. The workload: small simulated pulsars across a
few TOA-count classes (so several shape buckets are exercised), a
mod-7 sprinkle of polyco phase reads and a mod-3 sprinkle of
residual requests between the fit steps.

Two consumption modes:

- ``prebuild=True`` (bench): assemble each pulsar's linearized
  ``PulsarProblem`` once and share it across request objects — the
  serving-state hot path, so the measured loop is dispatch work, not
  model assembly;
- ``prebuild=False`` (demo daemon): requests carry (toas, model) and
  assemble at dispatch, exercising the admission-side path too.
"""

from __future__ import annotations

import io
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["BENCH_SIZES", "DEMO_SIZES", "synth_pulsar",
           "demo_polyco_entry", "build_workload"]

# six pulsars over three TOA buckets (64/128/256) — the committed
# bench_serve artifact's shape mix (ARCHITECTURE.md "Serving layer")
BENCH_SIZES: Tuple[int, ...] = (50, 60, 100, 120, 200, 180)
# the demo daemon's smaller three-class mix
DEMO_SIZES: Tuple[int, ...] = (50, 100, 200)


def synth_pulsar(k: int, ntoa: int, base: int = 1300, device=None):
    """One simulated white-noise pulsar (model, toas) on ``device``,
    deterministic per (k, ntoa, base); F0 perturbed so a fit step has
    real work."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_uniform

    par = (f"PSR J{base + k}\nRAJ 12:0{k % 10}:00.0 1\n"
           f"DECJ 30:0{k % 10}:00.0 1\nF0 {150.0 + 31.0 * k} 1\n"
           f"F1 -1e-15 1\nPEPOCH 55000\nPOSEPOCH 55000\n"
           f"DM {10 + k} 1\nTZRMJD 55000.1\nTZRSITE @\n"
           f"TZRFRQ 1400\nUNITS TDB\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = get_model(io.StringIO(par), device=device)
        t = make_fake_toas_uniform(
            54000, 56000, ntoa, m, error_us=1.0, add_noise=True,
            rng=np.random.default_rng(k), device=device)
    m.F0.add_delta(1e-10)
    m.invalidate_cache(params_only=True)
    return m, t


def demo_polyco_entry(psrname: str = "DEMO"):
    """The fixed polyco segment every phase read in the workload
    evaluates (host oracle: ``PolycoEntry.abs_phase``)."""
    from pint_tpu_torch.polycos import PolycoEntry

    return PolycoEntry(
        psrname=psrname, tmid=55000.0, rphase_int=1e9,
        rphase_frac=0.25, f0=200.0, obs="@", span_min=60.0,
        coeffs=np.array([0.02, 1e-3, -2e-5, 1e-7]))


def build_workload(nreq: int,
                   sizes: Optional[Sequence[int]] = None,
                   base: int = 1300, prebuild: bool = True,
                   with_kinds: bool = False,
                   entry_name: str = "BENCH", device=None):
    """Return ``fresh()``, a zero-arg builder of the request list.

    Request objects are single-shot (their future resolves once), so
    callers rebuild the list per pass while the expensive parts (the
    pulsars, the prebuilt problems, the polyco entry) are shared.
    ``with_kinds`` yields (kind, request) tuples (the demo daemon's
    form) instead of bare requests.
    """
    from pint_tpu_torch.serve import (
        FitStepRequest,
        PhasePredictRequest,
        ResidualsRequest,
    )

    sizes = tuple(BENCH_SIZES if sizes is None else sizes)
    pulsars = [synth_pulsar(k, ntoa, base=base, device=device)
               for k, ntoa in enumerate(sizes)]
    problems = None
    if prebuild:
        from pint_tpu_torch.parallel.pta import build_problem

        problems = [build_problem(t, m) for m, t in pulsars]
    entry = demo_polyco_entry(entry_name)

    def fresh():
        reqs = []
        for i in range(nreq):
            j = i % len(pulsars)
            if i % 7 == 6:
                mjds = 55000.0 + np.linspace(-0.01, 0.01, 24)
                kind, rq = "phase", PhasePredictRequest(entry, mjds)
            elif i % 3 == 2:
                kind = "residuals"
                rq = ResidualsRequest(problem=problems[j]) if prebuild \
                    else ResidualsRequest(*reversed(pulsars[j]))
            else:
                kind = "fit_step"
                rq = FitStepRequest(problem=problems[j]) if prebuild \
                    else FitStepRequest(*reversed(pulsars[j]))
            reqs.append((kind, rq) if with_kinds else rq)
        return reqs

    return fresh
