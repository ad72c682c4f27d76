"""Typed serve requests and their result futures (a port of
pint_tpu/serve/request.py; host code, copied).

The serving layer turns the library's one-model-one-call entry points into queued,
coalescable work items. Three request kinds exist, matching the three
hot read paths of a timing service:

- ``FitStepRequest``: one linearized GLS fit iteration (the unit
  ``parallel.fit_step`` computes and ``parallel.pta`` batches);
- ``ResidualsRequest``: residuals + whitened chi2 at the current
  parameter point (rides the SAME batched solve — its chi2 is the
  bases-only-marginalized ``chi2r`` output of ``pta._solve_one``, the
  quantity ``Residuals.chi2`` reports);
- ``PhasePredictRequest``: absolute-phase prediction from a polyco
  segment (``polycos.PolycoEntry``) at arbitrary MJDs — the
  phase-ephemeris read path (fold-mode observing, online dedispersion);
- ``PosteriorRequest``: a posterior-sampling run over the
  pulsar's linearized GLS posterior — the whole-chain-on-device
  stretch-move kernel of ``pint_tpu_torch.sampling.serve_kernel``, batched
  across pulsars by walker/step shape class, dispatched as
  supervised chunk dispatches with journalable per-chunk
  progress.

Every request carries an optional relative deadline and owns a
``ServeFuture``; the scheduler resolves the future when the request's
batch completes (or fails it with ``DeadlineExceeded`` /
``ServeOverload``).
"""

from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from pint_tpu_torch.runtime import locks

__all__ = ["ServeFuture", "DeadlineExceeded", "ServeOverload",
           "TenantOverQuota", "ShutdownShed", "EngineKilled",
           "StateMissing",
           "FitStepRequest", "ResidualsRequest", "PhasePredictRequest",
           "PosteriorRequest", "AppendTOAsRequest", "GWBRequest",
           "FitStepResult",
           "ResidualsResult", "PhasePredictResult", "PosteriorResult",
           "AppendResult", "GWBResult"]


# design evaluation (``build_problem``, ``build_append_rows``: the design
# matrix comes from one vmapped torch.func.jacfwd) is serialized
# process-wide. Two threads inside jacfwd at once break torch's
# process-global forward-AD levels ("Trying to access a forward AD level
# with an invalid index"), and every engine classifies on its submitters'
# threads — a fleet runs N engines. A lock, not a retry: assembly is host
# work that runs before dispatch, so waiting on it is queueing, never a
# hang of the card.
_DESIGN_LOCK = locks.make_lock("serve.design")


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its batch dispatched
    (expired in queue, shed by the deadline-aware admission policy,
    or dead on arrival at dispatch time)."""


class ServeOverload(RuntimeError):
    """Admission queue at capacity — backpressure signal to the
    caller (shed load or retry later; the queue cap is
    ``config.serve_queue_cap``)."""


class TenantOverQuota(ServeOverload):
    """The submitting tenant's token bucket is drained
    (``config.tenant_qps`` / ``$PINT_TPU_TENANT_QPS``): this tenant
    is bursting past its quota and is shed WITHOUT touching shared
    capacity — other tenants keep being admitted."""


class ShutdownShed(ServeOverload):
    """The engine is draining for shutdown and the bounded drain
    timeout elapsed before this request dispatched — shed with an
    explicit label instead of dying silently with the process."""


class EngineKilled(RuntimeError):
    """The engine was killed (injected ``kill_restart`` fault — the
    simulated SIGKILL of the restart-recovery harness): in-flight
    futures die unresolved exactly as a real process death would
    leave them; the journal's unacknowledged entries are what a
    restarted engine replays."""


class ServeFuture(concurrent.futures.Future):
    """The request's result future. On a synchronous (non-threaded)
    engine, ``result()`` pumps the engine's queue first so a plain
    submit-then-result sequence completes without a background
    thread; on a started engine the inherited blocking wait applies.
    """

    _sync_engine = None  # set by ServeEngine.submit when not threaded

    def result(self, timeout: Optional[float] = None):
        if self._sync_engine is not None and not self.done():
            self._sync_engine.flush()
        return super().result(timeout)


class Request:
    """Base serve request: deadline bookkeeping + future plumbing.

    ``deadline_s`` is RELATIVE (seconds from submission); the engine
    stamps the absolute expiry at admission. ``None`` = no deadline.

    ``tenant`` feeds the admission controller's per-tenant token
    buckets (None = the anonymous default tenant). ``rid`` +
    ``payload`` make a request journalable: ``payload`` is an opaque
    JSON-able description sufficient for the CALLER's replay factory
    to rebuild the request after a crash (the journal stores it
    verbatim; requests without one are served but never journaled —
    an in-memory object cannot be replayed into a fresh process).
    """

    kind = "?"

    def __init__(self, deadline_s: Optional[float] = None,
                 tenant: Optional[str] = None,
                 rid: Optional[str] = None,
                 payload: Optional[dict] = None):
        self.deadline_s = deadline_s
        self.tenant = tenant
        self.rid = rid
        self.payload = payload
        self.future = ServeFuture()
        self.admitted_at: Optional[float] = None  # time.monotonic()
        self.expires_at: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.expires_at is not None and now > self.expires_at


@dataclass
class FitStepResult:
    """One GLS correction, aligned with ``names`` (same contract as
    ``parallel.pta.fit_pta``: dparams is the correction to ADD, an
    implicit leading "Offset" unless the model carries PHOFF)."""

    names: List[str]
    dparams: np.ndarray
    cov: np.ndarray
    chi2: float       # linearized post-fit chi2
    chi2r: float      # chi2 at the current point (bases marginalized)

    def errors(self) -> Dict[str, float]:
        sig = np.sqrt(np.diag(self.cov))
        return {n: float(s) for n, s in zip(self.names, sig)
                if n != "Offset"}


@dataclass
class ResidualsResult:
    """Residuals at the current point plus the whitened chi2 the
    batched solve produced (= ``Residuals.chi2`` semantics)."""

    time_resids: np.ndarray   # [s]
    chi2: float

    @property
    def rms_us(self) -> float:
        return float(np.sqrt(np.mean(self.time_resids ** 2))) * 1e6


@dataclass
class PosteriorResult:
    """One pulsar's sampled linearized posterior: the thinned chain
    in PHYSICAL parameter units using the ``dparams`` convention of
    ``parallel.pta._solve_one`` (each sample is the correction to ADD
    to the current parameter values), aligned with ``names``."""

    names: List[str]
    chain: np.ndarray            # (S, W, p) thinned samples
    lnprob: np.ndarray           # (S, W)
    acceptance_fraction: float
    nsteps: int                  # un-thinned chain length actually run

    def flat(self, discard: int = 0) -> np.ndarray:
        """(S*W, p) flattened post-burn samples."""
        return self.chain[discard:].reshape(-1, self.chain.shape[-1])

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter posterior median/std of the correction."""
        flat = self.flat(discard=self.chain.shape[0] // 3)
        med = np.median(flat, axis=0)
        std = np.std(flat, axis=0)
        return {n: {"median": float(m), "std": float(s)}
                for n, m, s in zip(self.names, med, std)}


@dataclass
class PhasePredictResult:
    """Absolute phase split (int turns, frac turns) at the request's
    MJDs — same split as ``PolycoEntry.abs_phase``."""

    phase_int: np.ndarray
    phase_frac: np.ndarray


class _GLSRequest(Request):
    """Shared plumbing for the two request kinds that ride the batched
    GLS solve. Accepts either (toas, model) — assembled at dispatch —
    or a prebuilt ``parallel.pta.PulsarProblem`` (the serving-state
    form: a service holding hot pulsar states assembles once and
    re-solves on every poll, so admission stays O(1))."""

    def __init__(self, toas=None, model=None, problem=None,
                 track_mode=None, deadline_s: Optional[float] = None,
                 **kw):
        super().__init__(deadline_s=deadline_s, **kw)
        if problem is None and (toas is None or model is None):
            raise ValueError(
                f"{type(self).__name__} needs (toas, model) or a "
                f"prebuilt PulsarProblem")
        self.toas = toas
        self.model = model
        self.track_mode = track_mode
        self.problem = problem

    def ensure_problem(self):
        """Assemble (or return the cached) linearized problem."""
        if self.problem is None:
            from pint_tpu_torch.parallel.pta import build_problem

            with _DESIGN_LOCK:
                self.problem = build_problem(self.toas, self.model,
                                             track_mode=self.track_mode)
        return self.problem

    @property
    def sizes(self):
        """(ntoa, nparam, nbasis) — the shape-class inputs, read off
        the assembled problem (assembling it first if needed: any
        size heuristic computed without assembly could drift from
        build_problem's real shapes and misclassify the request)."""
        pr = self.ensure_problem()
        return (pr.M.shape[0], pr.M.shape[1], pr.F.shape[1])


class FitStepRequest(_GLSRequest):
    kind = "fit_step"


class ResidualsRequest(_GLSRequest):
    kind = "residuals"


class PosteriorRequest(_GLSRequest):
    """Sample the pulsar's linearized timing posterior.

    Rides the same assembled ``PulsarProblem`` as the GLS kinds; the
    served work is a whole-chain-on-device stretch-move ensemble run
    (``sampling.serve_kernel``). ``seed`` anchors the positional PRNG
    stream — a request's chain depends only on its own seed, never on
    its batch position, so a coalesced batch slot is bit-identical to
    the direct ``sample_problems`` path at the same shape class.
    ``nsteps`` is a RUNTIME budget (requests with different chain
    lengths share one shape class); ``nwalkers``/``thin``
    are part of the shape class."""

    kind = "posterior"

    def __init__(self, toas=None, model=None, problem=None,
                 nwalkers: int = 32, nsteps: int = 500,
                 seed: int = 0, thin: int = 1, **kw):
        super().__init__(toas=toas, model=model, problem=problem,
                         **kw)
        self.nwalkers = int(nwalkers)
        self.nsteps = int(nsteps)
        self.seed = int(seed)
        self.thin = max(1, int(thin))
        if self.nwalkers < 2 or self.nwalkers % 2:
            raise ValueError("nwalkers must be even and >= 2")
        if self.nsteps < 1 or self.nsteps >= 2 ** 31:
            # upper bound: the kernel's positional PRNG offset is an
            # int32 — past 2^31 fold_in streams would wrap and repeat
            raise ValueError("nsteps must be in [1, 2^31)")
        if self.nsteps % self.thin:
            raise ValueError("nsteps must be a multiple of thin")

    def ensure_problem(self):
        """The walker-count guard lives here, not in the kernel: the
        serve kernel's padded batch traces ndim, so
        ``build_stretch_chunk`` cannot check it — and an
        under-walkered stretch-move ensemble is confined to the
        affine hull of its start positions (dimensions beyond
        nwalkers-1 are silently never explored)."""
        pr = super().ensure_problem()
        if self.nwalkers < 2 * pr.M.shape[1]:
            raise ValueError(
                f"nwalkers={self.nwalkers} < 2*ndim"
                f"={2 * pr.M.shape[1]}: need an even nwalkers >= "
                "2*ndim for ensemble moves")
        return pr

    @property
    def walker_steps(self) -> int:
        """Total walker-updates this chain costs — the kind-local
        'rows' unit the capacity router learns posterior service
        rates in."""
        return self.nsteps * self.nwalkers


class StateMissing(RuntimeError):
    """An ``AppendTOAsRequest`` with ``cold=False`` named a pulsar
    state the engine does not hold (process restart lost the
    in-memory accumulator store, or the key was never cold-built):
    the caller must re-submit a cold build — silently rebuilding
    from only the appended rows would serve a fit of the tail of the
    data as if it covered all of it."""


@dataclass
class AppendResult:
    """One pulsar's re-converged incremental fit: ``dparams`` is the
    TOTAL correction to ADD to the model at the state's linearization
    point theta_0 (the ``parallel.pta`` convention), reflecting every
    TOA accumulated into the state INCLUDING this request's batch.
    ``chi2r`` is the bases-marginalized chi2 of the combined set at
    theta_0 (``Residuals.chi2`` semantics)."""

    names: List[str]
    dparams: np.ndarray
    cov: np.ndarray
    chi2: float          # linearized post-fit chi2, combined set
    chi2r: float         # chi2 at theta_0, combined set
    ntoa_total: int      # TOAs accumulated in the state after this
    cold: bool           # True when this request cold-built the state
    cg_iters: int

    def errors(self) -> Dict[str, float]:
        sig = np.sqrt(np.diag(self.cov))
        return {n: float(s) for n, s in zip(self.names, sig)
                if n != "Offset"}


class AppendTOAsRequest(_GLSRequest):
    """Append a batch of TOAs to a pulsar's cached accumulated normal
    equations and re-converge in O(new TOAs).

    ``state_key`` names the per-pulsar accumulator state the engine
    holds (``ServeEngine.append_store``). The FIRST request for a key
    is the cold build: ``toas`` is the full initial dataset,
    accumulated chunk-free into a fresh state whose noise-basis span
    is recorded. Subsequent requests carry ONLY the new TOAs: their
    rows are assembled at admission (O(new) host work — design
    matrix, residuals, and the noise basis evaluated on the COLD
    span's Fourier frequencies via the ``tspan`` override, so the
    columns align with the cached Gram), the device work is a rank
    update + preconditioned-CG re-solve of the small accumulated
    system, and the result is the total correction at the state's
    linearization point theta_0.

    Contract: the served model stays AT theta_0 (the linearized-
    serving convention PosteriorRequest also uses) — apply the
    returned ``dparams`` to a COPY if you want parameter values.
    Cold is EXPLICIT: only ``cold=True`` creates (or REBUILDS —
    that is how you re-linearize after a parameter/hyperparameter
    change) a state, and a warm append against a missing state
    fails with ``StateMissing`` instead of silently promoting
    itself to a cold build — otherwise a small append racing an
    in-flight cold build could install a tail-only state as if it
    covered the full dataset. ECORR models are rejected (appended
    epochs would grow the basis rank and break the fixed shape
    classes); wideband TOAs are rejected like every serve GLS kind.
    States are in-memory: after a process restart the first request
    per key must be cold."""

    kind = "append"

    def __init__(self, state_key: str, toas=None, model=None,
                 cold: Optional[bool] = None, **kw):
        super().__init__(toas=toas, model=model, **kw)
        self.state_key = str(state_key)
        self.cold = cold
        self._store = None   # bound by the engine at admission

    def bind_store(self, store):
        self._store = store

    def ensure_problem(self):
        """Assemble ONLY this request's rows, basis-aligned with the
        cached state (tspan pinned to the cold span). Raises
        ``StateMissing`` for a warm append with no cached state and
        ``ValueError`` for ECORR/wideband/shape-mismatched models."""
        if self.problem is not None:
            return self.problem
        from pint_tpu_torch.serve.append import build_append_rows

        entry = None
        if self._store is not None:
            entry = self._store.get(self.state_key)
        cold = self.cold
        if cold is None:
            # never auto-promote to cold: an unspecified-cold append
            # is a WARM append, and a missing state is an error — a
            # tail batch must not masquerade as the full dataset
            # (e.g. racing an in-flight cold build, or after a
            # process restart lost the store)
            cold = False
        if not cold and entry is None:
            raise StateMissing(
                f"append state {self.state_key!r} not found (process "
                f"restart, or never cold-built?); submit a cold "
                f"build (cold=True with the full dataset) first")
        self.cold = bool(cold)
        tspan = None if cold or entry is None else entry.tspan
        tref = None if cold or entry is None else entry.tref
        with _DESIGN_LOCK:
            self.problem = build_append_rows(
                self.toas, self.model, tspan=tspan, tref=tref,
                track_mode=self.track_mode)
        if entry is not None and not cold:
            entry.check_compatible(self.problem)
        return self.problem


@dataclass
class GWBResult:
    """One array's swept GWB detection grid: ``logL[k]`` is the
    Hellings–Downs cross-correlated marginal log-likelihood at
    ``(log10A[k], gamma[k])`` (``pta.gwb.GWBLikelihood`` semantics —
    the improper-prior constant is dropped, so COMPARE values across
    the grid, don't read them absolutely)."""

    logL: np.ndarray             # (npts,)
    log10A: np.ndarray           # (npts,) the grid actually swept
    gamma: np.ndarray            # (npts,)
    npulsars: int
    nfreq: int

    def best(self) -> Dict[str, float]:
        """The grid's maximum-likelihood point."""
        k = int(np.argmax(self.logL))
        return {"log10A": float(self.log10A[k]),
                "gamma": float(self.gamma[k]),
                "logL": float(self.logL[k])}


class GWBRequest(Request):
    """Sweep the array-level GWB likelihood over a hyperparameter
    grid.

    Carries a whole pulsar ARRAY (``pairs`` of (toas, model), prebuilt
    ``PulsarProblem``s, or a prebuilt ``pta.gwb.GWBLikelihood`` — the
    serving-state form: a service holding a hot array builds the
    likelihood once, blocks and all, and re-sweeps per request). The
    served work is the chunked outer Schur sweep
    (``pta.gwb.gwb_sweep_driver``): each chunk of
    ``config.gwb_chunk()`` grid points is one supervised dispatch, so
    the chunk boundary is the failover/deadline boundary and journal
    progress is acked per chunk — not in the warm-restart store (the
    blocks are long-lived request state, exactly the posterior
    chains' rationale). ``log10A``/``gamma`` are RUNTIME grids
    (requests with different grids share a shape class);
    the shape class is (npulsars, basis size, chunk)."""

    kind = "gwb"

    def __init__(self, pairs=None, problems=None, likelihood=None,
                 log10A=None, gamma=None, nfreq: int = 10,
                 positions=None, gamma_matrix=None, track_mode=None,
                 **kw):
        super().__init__(**kw)
        if likelihood is None and pairs is None and problems is None:
            raise ValueError(
                "GWBRequest needs pairs, problems, or a prebuilt "
                "GWBLikelihood")
        self.pairs = pairs
        self.problems = problems
        self.likelihood = likelihood
        self.positions = positions
        self.gamma_matrix = gamma_matrix
        self.nfreq = int(nfreq)
        self.track_mode = track_mode
        self.log10A = np.atleast_1d(
            np.asarray(log10A, np.float64)).ravel()
        self.gamma = np.atleast_1d(
            np.asarray(gamma, np.float64)).ravel()
        if self.log10A.shape != self.gamma.shape:
            raise ValueError(
                f"log10A grid ({self.log10A.shape}) and gamma grid "
                f"({self.gamma.shape}) must have the same length")
        if len(self.log10A) < 1:
            raise ValueError("GWBRequest needs a non-empty grid")

    def ensure_likelihood(self, mesh=None, axis: str = "pulsar",
                          supervisor=None, device=None):
        """Build (or return the cached) array likelihood on ``device``
        (the engine's; the GPU by default). The engine's ``mesh``
        threads through, so the inner block assembly is split over its
        pulsar ``axis``."""
        if self.likelihood is None:
            from pint_tpu_torch.pta.gwb import GWBLikelihood

            with _DESIGN_LOCK:
                self.likelihood = GWBLikelihood(
                    pairs=self.pairs, problems=self.problems,
                    positions=self.positions,
                    gamma_matrix=self.gamma_matrix, nfreq=self.nfreq,
                    device=device, mesh=mesh, axis=axis,
                    supervisor=supervisor,
                    track_mode=self.track_mode)
        return self.likelihood

    @property
    def npoints(self) -> int:
        """Grid points this sweep costs — the kind-local 'rows' unit
        the capacity router learns GWB service rates in."""
        return len(self.log10A)

    @property
    def sizes(self):
        """(npulsars, basis columns) — the shape-class inputs, read
        off the assembled likelihood."""
        lk = self.ensure_likelihood()
        return (lk.npulsars, lk.m)


class PhasePredictRequest(Request):
    """Evaluate one polyco segment's absolute phase at ``mjds``.

    The entry is host-fit once (``Polycos.generate_polycos``) and then
    served read-only; the per-request device work is the padded,
    batched polynomial evaluation in ``serve.bucket``."""

    kind = "phase"

    def __init__(self, entry, mjds, deadline_s: Optional[float] = None,
                 **kw):
        super().__init__(deadline_s=deadline_s, **kw)
        self.entry = entry
        self.mjds = np.atleast_1d(np.asarray(mjds, np.float64))

    @property
    def sizes(self):
        """(nmjd, ncoeff) — the phase shape-class inputs."""
        return (len(self.mjds), len(np.asarray(self.entry.coeffs)))
