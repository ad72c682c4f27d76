"""Profiling and fit statistics (a port of pint_tpu/profiling.py).

Two layers:

- ``FitStats``: the structured per-fit stats object every fitter
  attaches (chi2, iterations, wall time, TOAs/sec).
- ``trace``/``annotate``: thin wrappers over ``torch.profiler`` so a
  fit can be decomposed (phase chain vs jacfwd vs Cholesky) in a
  Chrome trace, plus a process-wide scoreboard of named wall-clock
  phases for quick attribution without a trace viewer.
"""

from __future__ import annotations

import contextlib
import json
from pint_tpu_torch.runtime import locks
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

__all__ = ["FitStats", "trace", "annotate", "scoreboard", "Scoreboard"]


@dataclass
class FitStats:
    """Structured result of one fit (returned via Fitter.stats)."""

    fitter: str = ""
    ntoa: int = 0
    nfree: int = 0
    dof: int = 0
    chi2: float = float("nan")
    reduced_chi2: float = float("nan")
    iterations: int = 0
    converged: bool = False
    wall_time_s: float = 0.0
    toas_per_sec: float = 0.0
    phases: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    def __str__(self) -> str:
        return (f"{self.fitter}: chi2={self.chi2:.3f} "
                f"(red. {self.reduced_chi2:.4f}), "
                f"{self.iterations} iter in {self.wall_time_s * 1e3:.1f} ms "
                f"({self.toas_per_sec:.0f} TOA/s)")


class Scoreboard:
    """Accumulates named wall-clock phases; the cheap always-on half of
    the profiling story (the expensive half is torch.profiler traces).

    The phase rows are REGISTRY-BACKED — each phase holds a shared
    ``obs.metrics`` histogram row
    (``pint_tpu_scoreboard_seconds{scope, phase}``, the
    ``row_factory`` pattern), so ``annotate()`` regions appear in
    ``/metrics`` instead of a report-only dict.
    ``totals``/``counts`` are derived views of the SAME rows (the
    registry-vs-snapshot parity discipline); ``obs.reset()`` clears
    the scoreboard with the registry it was bound to."""

    def __init__(self):
        self._lock = locks.make_lock("profiling.scoreboard")
        self._rows: Dict[str, object] = {}
        self._scope: Optional[str] = None

    def _row(self, name: str):
        row = self._rows.get(name)
        if row is None:
            from pint_tpu_torch.obs import metrics as om

            with self._lock:
                row = self._rows.get(name)
                if row is None:
                    if self._scope is None:
                        # per-instance scope: two scoreboards (the
                        # global one, a test's) must never share rows
                        self._scope = om.new_scope("sb")
                    row = om.histogram(
                        "pint_tpu_scoreboard_seconds",
                        "annotate()/phase wall per named region"
                    ).row(scope=self._scope, phase=name)
                    self._rows[name] = row
        return row

    @contextlib.contextmanager
    def phase(self, name: str):
        row = self._row(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            row.record(time.perf_counter() - t0)

    # -- derived views ------------------------------------------------

    @property
    def totals(self) -> Dict[str, float]:
        with self._lock:
            rows = dict(self._rows)
        return {k: r.sum_s for k, r in rows.items() if r.count}

    @property
    def counts(self) -> Dict[str, int]:
        with self._lock:
            rows = dict(self._rows)
        return {k: r.count for k, r in rows.items() if r.count}

    def snapshot(self) -> dict:
        """{phase: histogram snapshot}."""
        with self._lock:
            rows = dict(self._rows)
        return {k: r.snapshot() for k, r in sorted(rows.items())
                if r.count}

    def report(self) -> str:
        totals, counts = self.totals, self.counts
        lines = [f"{'phase':<28} {'total_s':>10} {'calls':>7} {'avg_ms':>10}"]
        for k in sorted(totals, key=totals.get, reverse=True):
            t, c = totals[k], counts[k]
            lines.append(f"{k:<28} {t:>10.3f} {c:>7} {t / c * 1e3:>10.2f}")
        return "\n".join(lines)

    def reset(self):
        """Drop the rows (obs.reset calls this: the registry they
        were bound to was just swapped — fresh phases register
        fresh rows, stale rows stop being visible anywhere)."""
        with self._lock:
            self._rows.clear()


scoreboard = Scoreboard()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (CPU ops and, when CUDA is
    up, the card's kernels) around a block and write it to
    ``<logdir>/trace.json`` (Chrome trace format; Perfetto or
    chrome://tracing reads it). No-op when logdir is None.

    This is the UNMANAGED form for scripts that own their own lifetime.
    Running code wants ``pint_tpu_torch.obs.perf.request_window``
    instead: bounded ($PINT_TPU_PROFILE_MAX_S), rate-limited, hang-proof,
    with cross-linked window metadata, and fired on its own on
    slo_burn/breaker-open incidents."""
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region: feeds the scoreboard AND opens a tracer span under
    the current causal context, which an open torch.profiler session
    records as a ``record_function`` range of the same name (``obs``)
    — ONE instrumentation point serves the profiler, the process
    scoreboard and the structured trace. With tracing off and no
    profiler session the span is the shared no-op."""
    from pint_tpu_torch import obs

    with scoreboard.phase(name), obs.span(name, kind="annotate"):
        yield
