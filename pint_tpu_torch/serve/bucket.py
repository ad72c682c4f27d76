"""Shape-class bucketing + the per-engine class-program registry (a
port of pint_tpu/serve/bucket.py).

Every request is padded to a shape CLASS:

- the TOA/MJD axis pads to a power-of-two bucket edge
  (``config.serve_bucket_edges``, default 64..16384);
- the parameter and noise-basis axes pad to multiples of 8 (padded
  columns are identity-pinned / unit-prior, exactly the
  ``parallel.pta`` masking contract);
- the batch (request) axis pads to a power of two up to
  ``config.serve_max_batch`` (to a mesh multiple when the engine splits
  the batch axis over a device mesh).

The reference bounds XLA compiles by the class count. Eager torch
compiles nothing, so the classes bound something else here: the shapes
the card's allocator and its cuBLAS/cuSOLVER batched routines see, and
the batch occupancy. ``ExecutableCache`` keeps the reference's
accounting: ``compile_count`` is the number of distinct classes that
completed a real device dispatch.

The class programs are batched float64 torch functions over a leading
(P, ...) slot axis where the reference uses ``jax.vmap``:
``parallel.pta._solve_one`` (GLS and residuals), ``_phase_eval_one``
(polyco phase), ``serve.append._append_slot`` (the append rank update),
``sampling.serve_kernel.make_posterior_slot`` (posterior chains) and
``pta.gwb.gwb_sweep_driver`` (GWB sweeps).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch import resolve_device
from pint_tpu_torch.parallel.pta import STACK_KEYS, _PTA_NDIMS_OUT, \
    _solve_one, pta_solve_np, read_back, stack_problems
from pint_tpu_torch.pta.shard import mesh_devices, run_batch

__all__ = ["bucket_for", "pad_dim", "pow2_ceil", "ExecutableCache",
           "gls_shape_class", "phase_shape_class",
           "posterior_shape_class", "append_shape_class",
           "gwb_shape_class"]

PHASE_KEYS = ("coeffs", "tmid", "rpi", "rpf", "f0", "mjds", "valid")
APPEND_KEYS = ("cm", "Sig", "b", "u", "scal", "M", "F", "phi", "r0",
               "nvec", "valid", "pvalid", "submean", "cold")
# ranks of the append program's outputs (its block plan under a mesh)
_APPEND_NDIMS_OUT = (2, 3, 2, 2, 2, 2, 3, 1, 1, 1, 1)
# inputs of a masking-safe zero batch that must be ONE, not zero (the
# padded-slot convention of stack_problems: unit nvec and phi)
_UNIT_INPUTS = {"gls": ("phi", "nvec"), "phase": ()}


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(1, int(n)) - 1).bit_length()


def bucket_for(n: int, edges: Tuple[int, ...]) -> Optional[int]:
    """Smallest bucket edge >= n, or None when n exceeds every edge
    (the scheduler's single-request fallback case)."""
    for e in edges:
        if n <= e:
            return e
    return None


def pad_dim(d: int, multiple: int = 8) -> int:
    """Pad a (parameter / basis) axis to a multiple; 0 stays 0 so
    white-noise models don't drag a dead basis block through the
    solve."""
    if d == 0:
        return 0
    return ((d + multiple - 1) // multiple) * multiple


def gls_shape_class(n: int, p: int, q: int, edges: Tuple[int, ...]):
    """(kind, N_bucket, p_pad, q_pad) for a fit/residuals request —
    or None when the TOA count exceeds every bucket edge. Fit and
    residual requests share classes: the solve kernel is
    structure-agnostic (it consumes padded matrices), so the
    component-structure part of the serve cache key collapses to the
    request kind class; the structure-sensitive work (the phase chain
    per model) stays in the model layer."""
    nb = bucket_for(n, edges)
    if nb is None:
        return None
    return ("gls", nb, pad_dim(p), pad_dim(q))


def phase_shape_class(nmjd: int, ncoeff: int, edges: Tuple[int, ...]):
    """(kind, N_bucket, k_pad) for a phase-prediction request."""
    nb = bucket_for(nmjd, edges)
    if nb is None:
        return None
    return ("phase", nb, pad_dim(ncoeff, 4))


def posterior_shape_class(n: int, p: int, q: int, W: int, K: int,
                          thin: int, edges: Tuple[int, ...]):
    """(kind, N_bucket, p_pad, q_pad, W, K, thin) for a posterior
    request — or None when the TOA count exceeds every bucket edge.
    The problem axes bucket like GLS classes (same padded masking);
    the WALKER count and the chunked-scan length K ride in the key
    EXACTLY (not padded): both fix the chain program
    (``make_posterior_slot(W, K)``), W is pinned by the request (padding it would
    change the PRNG stream and break bit-equality with the direct
    ``sample_problems`` path), and K is already quantized by
    ``config.chain_chunk_steps`` — the actual per-request ``nsteps``
    is a runtime budget, so distinct chain lengths share a class."""
    nb = bucket_for(n, edges)
    if nb is None:
        return None
    return ("posterior", nb, pad_dim(p), pad_dim(q), int(W), int(K),
            int(thin))


def append_shape_class(n: int, p: int, q: int,
                       edges: Tuple[int, ...]):
    """(kind, N_bucket, p_pad, q_pad) for an append request — the
    NEW-row count buckets like a GLS TOA axis (the accumulated state
    is already padded to (p_pad, q_pad), so state and rows share one
    class), or None when the batch exceeds every edge (the cold-build
    fallback-single case)."""
    nb = bucket_for(n, edges)
    if nb is None:
        return None
    return ("append", nb, pad_dim(p), pad_dim(q))


def gwb_shape_class(P: int, m: int, K: int):
    """(kind, npulsars, basis columns, chunk) for a GWB sweep
    request. EXACT, never None: the sweep programs are keyed on
    the array size, the common-basis column count and the sweep
    chunk — the hyperparameter GRIDS are runtime args (distinct
    grids share a class), and there is no TOA axis to bucket (the
    per-pulsar blocks are request state, assembled once)."""
    return ("gwb", int(P), int(m), int(K))


def _phase_eval_one(coeffs, tmid, rphase_int, rphase_frac, f0, mjds,
                    valid):
    """Polyco segments' absolute phase at padded MJDs, batched over a
    leading slot axis (coeffs (P, k), tmid/rphase_*/f0 (P,), mjds and
    valid (P, nb); a mirror of ``polycos.PolycoEntry.abs_phase``).
    Horner from the highest coefficient, the evaluation order of
    np.polynomial.polynomial.polyval; zero-padded high coefficients
    contribute exact zeros. Padded MJD slots carry dt=0 and are zeroed
    by ``valid`` on the way out."""
    dt = (mjds - tmid[..., None]) * 1440.0
    poly = torch.zeros_like(dt)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        poly = poly * dt + coeffs[..., i:i + 1]
    spin = 60.0 * f0[..., None] * dt
    spin_i = torch.floor(spin)
    frac = rphase_frac[..., None] + (spin - spin_i) + poly
    carry = torch.floor(frac)
    return (rphase_int[..., None] + spin_i + carry) * valid, \
        (frac - carry) * valid


def _zero_batch(kind: str, avals, device) -> list:
    """The masking-safe zero batch of a class: every slot padded
    (valid = pvalid = 0; unit nvec and phi for GLS)."""
    names = STACK_KEYS if kind == "gls" else PHASE_KEYS
    ones = _UNIT_INPUTS[kind]
    return [(torch.ones if n in ones else torch.zeros)(
        tuple(shape), dtype=torch.float64, device=device)
        for n, (shape, _) in zip(names, avals)]


class ExecutableCache:
    """Per-engine registry of the class programs and of the classes
    dispatched.

    Every dispatch routes through the runtime supervisor on the engine's
    ``device`` (the GPU by default): watchdog deadline + host failover
    (the numpy mirror for GLS and append, ``PolycoEntry.abs_phase`` for
    phase), so a wedged card can never hang a serve batch — only slow
    it down, labeled. With ``mesh`` (``pta.shard.Mesh``) the GLS,
    phase and append programs split the batch axis into contiguous
    per-device blocks over the mesh's ``axis`` (``_run``); ``device``
    then defaults to the mesh's first device, whose breaker the
    dispatches consult. Each engine owns its cache, so a mesh engine and
    a local engine never share an entry, and the warm-restart store is
    off under a mesh, as in the reference."""

    def __init__(self, mesh=None, axis: str = "pulsar",
                 supervisor=None, aot_dir=None, device=None):
        from pint_tpu_torch.config import donation_enabled
        from pint_tpu_torch.runtime import get_supervisor

        self.mesh = mesh
        self.axis = axis
        home = None if mesh is None else mesh_devices(mesh, axis)[0]
        self.device = resolve_device(device) \
            if home is None or device is not None else home
        # $PINT_TPU_DONATE is parsed, but eager torch has no buffer
        # donation: every class program allocates its outputs, and the
        # snapshot records donation off whatever the knob says
        donation_enabled()
        self.donation = False
        # the class programs: batched torch functions over the leading
        # slot axis (one function serves every class of its kind)
        self._gls = _solve_one
        self._phase = _phase_eval_one
        self._append = None
        # posterior chunk functions, one per (W, K, thin): W and K are
        # fixed by the chunk function (PRNG stream layout, scan length)
        self._posterior: dict = {}
        self.supervisor = supervisor or get_supervisor()
        self.keys: set = set()
        # warm restart: with an aot_dir, every GLS/phase class is
        # recorded right after its first real device dispatch, and a
        # fresh engine primes the recorded classes at construction
        self.aot = None
        if aot_dir and mesh is None:
            from pint_tpu_torch.serve.journal import AotStore

            self.aot = AotStore(aot_dir, donation=self.donation,
                                device=self.device)
            self.aot.restore_all(supervisor=self.supervisor,
                                 primers=self._primers())
        # pull-gauges into the metric registry — compile count and
        # cache entries per engine, evaluated at scrape time through a
        # weakref (a dead engine's gauge just stops producing samples)
        import weakref

        from pint_tpu_torch.obs import metrics as om

        ref = weakref.ref(self)
        scope = om.new_scope("cache")
        om.gauge("pint_tpu_jit_cache_size",
                 "live jit-cache entries per engine executable "
                 "cache").set_fn(
            lambda: (lambda c: c.jit_cache_size()
                     if c is not None else None)(ref()),
            scope=scope)
        om.gauge("pint_tpu_serve_compile_count",
                 "distinct shape classes compiled per engine"
                 ).set_fn(
            lambda: (lambda c: c.compile_count
                     if c is not None else None)(ref()),
            scope=scope)

    @property
    def compile_count(self) -> int:
        """Distinct shape classes that completed a real device
        dispatch (the reference's definition: there, the executables
        built)."""
        return len(self.keys)

    def jit_cache_size(self) -> Optional[int]:
        """None: eager torch keeps no compiled-executable cache (the
        reference returns None too when jax exposes no cache size)."""
        return None

    def _run(self, fn, arrs: dict, keys, name: str, ndims_out):
        """One batch of the class program ``fn`` on the engine's device
        or, under a mesh, its block plan (``pta.shard.run_batch``)."""
        return run_batch(fn, arrs, keys, name=name, ndims_out=ndims_out,
                         mesh=self.mesh, axis=self.axis, device=self.device)

    def _primers(self) -> dict:
        """``AotStore.restore_all``'s primers: run the class program
        once on its masking-safe zero batch on the device, read the
        result back, and return the program."""
        def primer(kind):
            def prime(avals):
                fn = self._gls if kind == "gls" else self._phase
                read_back(fn(*_zero_batch(kind, avals, self.device)))
                return fn
            return prime

        return {"gls": primer("gls"), "phase": primer("phase")}

    def _class_callbacks(self, kind, key, dispatch_key, program,
                         shapes, pool, restored):
        """(export_cb, ledger_cb) of a class still owing its store
        record or its compile-ledger cost entry (None otherwise). The
        ledger probe counts the program's FLOPs on a zero batch of meta
        tensors (shapes only: no memory, no arithmetic), on a background
        thread (``defer_cost``): never on a serve dispatch path, never
        on the card."""
        need_export = self.aot is not None and restored is None and \
            pool == "device" and not self.aot.has(kind, key)
        need_ledger = restored is None and pool == "device" and \
            key not in self.keys
        export_cb = ledger_cb = None
        avals = tuple((tuple(s), "float64") for s in shapes)
        if need_export:
            export_cb = lambda: self.aot.save(  # noqa: E731
                kind, key, program, avals)
        if need_ledger:
            from pint_tpu_torch.obs import perf as _perf
            from pint_tpu_torch.runtime import backend_of

            ledger_cb = lambda: _perf.note_compile(  # noqa: E731
                dispatch_key, kind=f"serve.{kind}",
                backend=backend_of(self.device), fn=program,
                args=_zero_batch(kind, avals, "meta"), defer_cost=True)
        return export_cb, ledger_cb

    def _issue(self, run, host, dispatch_key, class_key, sync: bool,
               pool: str = "device", info: Optional[dict] = None,
               export_cb=None, restored: bool = False,
               ledger_cb=None):
        """Shared issue/collect plumbing: ``sync`` runs the
        supervised dispatch inline (the classic drain); otherwise the
        dispatch is ISSUED on the supervisor's pipeline mode
        (``dispatch_async``) and the returned zero-arg ``collect``
        blocks on its DispatchFuture — batch k+1's device work then
        overlaps batch k's result read. The class key is recorded at
        collect time, only on a real (non-failed-over) device
        dispatch; ``export_cb`` (the store record of a new class)
        fires on the same condition.

        ``pool`` is the capacity router's verdict: "host" runs the
        numpy mirror as a PINNED supervised dispatch — hang-free by
        construction, bypassing the device breaker entirely (a routed
        host solve is planned capacity, not a failover). ``info``
        (when given) is filled with the pool that actually produced
        the result, for the router's rate learning."""
        from pint_tpu_torch import obs

        if info is None:
            info = {}
        info.setdefault("pool", pool)

        if pool == "host":
            if sync:
                def collect():
                    with obs.span("serve.pool.host",
                                  key=dispatch_key):
                        out = self.supervisor.dispatch(
                            host, key=dispatch_key, pinned=True)
                    info["used_pool"] = "host"
                    return out
            else:
                with obs.span("serve.pool.host.issue",
                              key=dispatch_key):
                    fut = self.supervisor.dispatch_async(
                        host, key=dispatch_key, pinned=True)

                def collect():
                    out = fut.result()
                    info["used_pool"] = "host"
                    return out

            return collect

        fell_over = []

        def host_counted():
            fell_over.append(True)
            return host()  # graftlint: allow G6 -- inside the host failover the supervisor itself runs (fallback=host_counted): the numpy mirror on the host, no device call

        def _record():
            if fell_over:
                info["used_pool"] = "host-failover"
                return
            info["used_pool"] = "device"
            if not restored:
                self.keys.add(class_key)
                if export_cb is not None:
                    export_cb()
                if ledger_cb is not None:
                    ledger_cb()

        if sync:
            # LAZY: the dispatch runs inside collect, so the caller's
            # annotate("serve.dispatch") region wraps the real device
            # work in sync mode too
            def collect():
                with obs.span("serve.pool.device",
                              key=dispatch_key):
                    out = self.supervisor.dispatch(
                        run, key=dispatch_key, device=self.device,
                        fallback=host_counted)
                _record()
                return out
        else:
            with obs.span("serve.pool.device.issue",
                          key=dispatch_key):
                fut = self.supervisor.dispatch_async(
                    run, key=dispatch_key, device=self.device,
                    fallback=host_counted)

            def collect():
                out = fut.result()
                _record()
                return out

        return collect

    def gls_begin(self, key, problems, shape, sync: bool = False,
                  pool: str = "device", info: Optional[dict] = None):
        """Pad ``problems`` to the class shape (``parallel.pta``
        masking) and issue the batch as one SUPERVISED dispatch
        (runtime watchdog; host ``pta_solve_np`` failover): one upload,
        the batched ``_solve_one``, one read back. Returns a zero-arg
        ``collect`` whose call yields host arrays (dparams, cov, chi2,
        chi2r), each (P, ...). The class key is recorded only on a
        real device dispatch: a failed or failed-over dispatch does
        not count. ``pool="host"`` runs the numpy mirror as planned
        capacity instead."""
        stacked = stack_problems(problems, shape=shape)
        restored = None
        if pool == "device" and self.aot is not None:
            restored = self.aot.get("gls", key)

        def run():
            # upload + solve + read back on the guarded worker so the
            # deadline covers completion, not just enqueue
            fn = restored if restored is not None else self._gls
            return self._run(fn, stacked, STACK_KEYS, "serve.gls",
                             _PTA_NDIMS_OUT)

        dispatch_key = f"serve.gls/{'/'.join(str(x) for x in key)}"
        export_cb, ledger_cb = self._class_callbacks(
            "gls", key, dispatch_key, self._gls,
            [stacked[k].shape for k in STACK_KEYS], pool, restored)
        return self._issue(
            run, lambda: pta_solve_np(stacked),
            dispatch_key, key, sync,
            pool=pool, info=info, export_cb=export_cb,
            restored=restored is not None, ledger_cb=ledger_cb)

    def gls(self, key, problems, shape):
        """Synchronous ``gls_begin`` + collect."""
        return self.gls_begin(key, problems, shape, sync=True)()

    def phase_begin(self, key, requests, nb: int, kb: int, Pb: int,
                    sync: bool = False, pool: str = "device",
                    info: Optional[dict] = None):
        """Pad phase requests to (Pb, nb) MJDs x kb coefficients and
        issue the batch as one supervised dispatch (host failover:
        per-entry ``PolycoEntry.abs_phase``; key recorded on a real
        device dispatch only, as in ``gls_begin``). Returns the
        zero-arg ``collect``. ``pool``/``info`` as in ``gls_begin``.
        """
        coeffs = np.zeros((Pb, kb))
        tmid = np.zeros(Pb)
        rpi = np.zeros(Pb)
        rpf = np.zeros(Pb)
        f0 = np.zeros(Pb)
        mjds = np.zeros((Pb, nb))
        valid = np.zeros((Pb, nb))
        for k, rq in enumerate(requests):
            e = rq.entry
            c = np.asarray(e.coeffs, np.float64)
            coeffs[k, :len(c)] = c
            tmid[k] = e.tmid
            rpi[k] = e.rphase_int
            rpf[k] = e.rphase_frac
            f0[k] = e.f0
            m = rq.mjds
            mjds[k, :len(m)] = m
            mjds[k, len(m):] = e.tmid  # dt = 0 on padded slots
            valid[k, :len(m)] = 1.0
        arrs = {"coeffs": coeffs, "tmid": tmid, "rpi": rpi, "rpf": rpf,
                "f0": f0, "mjds": mjds, "valid": valid}

        restored = None
        if pool == "device" and self.aot is not None:
            restored = self.aot.get("phase", key)

        def run():
            fn = restored if restored is not None else self._phase
            return self._run(fn, arrs, PHASE_KEYS, "serve.phase", (2, 2))

        def host():
            pi = np.zeros((Pb, nb))
            pf = np.zeros((Pb, nb))
            for k, rq in enumerate(requests):
                n = len(rq.mjds)
                hi, hf = rq.entry.abs_phase(rq.mjds)
                pi[k, :n] = hi
                pf[k, :n] = hf
            return pi, pf

        dispatch_key = f"serve.phase/{'/'.join(str(x) for x in key)}"
        export_cb, ledger_cb = self._class_callbacks(
            "phase", key, dispatch_key, self._phase,
            [arrs[k].shape for k in PHASE_KEYS], pool, restored)
        return self._issue(
            run, host,
            dispatch_key, key, sync,
            pool=pool, info=info, export_cb=export_cb,
            restored=restored is not None, ledger_cb=ledger_cb)

    def phase(self, key, requests, nb: int, kb: int, Pb: int):
        """Synchronous ``phase_begin`` + collect."""
        return self.phase_begin(key, requests, nb, kb, Pb,
                                sync=True)()

    def append_begin(self, key, requests, shape, entries,
                     sync: bool = False, pool: str = "device",
                     info: Optional[dict] = None):
        """Pad the append batch to its class shape and issue ONE
        supervised dispatch of the batched rank-update + CG-resolve
        slot program (``serve.append._append_slot``). ``entries`` is
        the per-request list of cached ``AppendStateEntry`` (None
        for cold slots — they start from the zero state). The program
        is PURE: it returns per-slot state DELTAS; the scheduler
        commits them to the store at collect time. Not recorded in the
        warm-restart store: a restored class could not resurrect the
        in-memory state store anyway. Host failover: the numpy
        mirror ``append_slot_np`` per slot."""
        from pint_tpu_torch.serve.append import append_slot_np

        Pb, nb, pb, qb = shape
        P = pb + qb
        cm = np.ones((Pb, pb))
        Sig = np.zeros((Pb, P, P))
        bb = np.zeros((Pb, P))
        uu = np.zeros((Pb, P))
        scal = np.zeros((Pb, 8))
        M = np.zeros((Pb, nb, pb))
        F = np.zeros((Pb, nb, qb))
        phi = np.ones((Pb, qb))
        r0 = np.zeros((Pb, nb))
        nvec = np.ones((Pb, nb))
        valid = np.zeros((Pb, nb))
        pvalid = np.zeros((Pb, pb))
        submean = np.zeros(Pb)
        coldf = np.zeros(Pb)
        budget = 8 * (pb + 1)
        if info is not None:
            # the health tap thresholds CG effort against the budget
            # THE PROGRAM ACTUALLY RAN — threaded, never recomputed
            info["append_cg_budget"] = int(budget)
        for k, r in enumerate(requests):
            pr = r.problem
            n, p = pr.M.shape
            q = pr.F.shape[1]
            M[k, :n, :p] = pr.M
            F[k, :n, :q] = pr.F
            phi[k, :q] = pr.phi
            r0[k, :n] = pr.r
            nvec[k, :n] = pr.nvec
            valid[k, :n] = 1.0
            pvalid[k, :p] = 1.0
            submean[k] = 1.0 if pr.submean else 0.0
            e = entries[k]
            if e is None:
                coldf[k] = 1.0
            else:
                cm[k] = e.cm
                Sig[k] = e.Sig
                bb[k] = e.b
                uu[k] = e.u
                scal[k] = e.scal
                phi[k] = e.stacked_phi()
        arrs = {"cm": cm, "Sig": Sig, "b": bb, "u": uu, "scal": scal,
                "M": M, "F": F, "phi": phi, "r0": r0, "nvec": nvec,
                "valid": valid, "pvalid": pvalid, "submean": submean,
                "cold": coldf}
        if self._append is None:
            from pint_tpu_torch.serve.append import append_kernel

            self._append = append_kernel()
        fn = self._append

        def program(*a):
            # ok and iters ride the one read back as float64
            return tuple(o.to(torch.float64)
                         for o in fn(*a, budget, 1e-13))

        def run():
            return _append_host(self._run(
                program, arrs, APPEND_KEYS, f"serve.append/{budget}",
                _APPEND_NDIMS_OUT))

        def host():
            outs = [append_slot_np(
                cm[k], Sig[k], bb[k], uu[k], scal[k], M[k], F[k],
                phi[k], r0[k], nvec[k], valid[k], pvalid[k],
                submean[k], coldf[k], budget=int(budget))
                for k in range(Pb)]
            return tuple(np.stack([np.asarray(o[j]) for o in outs])
                         for j in range(11))

        return self._issue(
            run, host,
            f"serve.append/{'/'.join(str(x) for x in key)}", key,
            sync, pool=pool, info=info)

    def _posterior_kernel(self, W: int, K: int, thin: int):
        from pint_tpu_torch.sampling.serve_kernel import (
            make_posterior_slot,
        )

        ck = (W, K, thin)
        if ck not in self._posterior:
            self._posterior[ck] = make_posterior_slot(W, K, thin=thin)
        return self._posterior[ck]

    def posterior_begin(self, key, requests, shape,
                        sync: bool = False, pool: str = "device",
                        info: Optional[dict] = None, progress=None):
        """Pad the requests' problems to the class shape and run the
        posterior chains as CHUNKED supervised dispatches
        (``sampling.serve_kernel.posterior_chunk_driver``): each chunk
        of K steps is its own deadline-bounded dispatch with a CPU
        failover that continues from the carried state, so long chains
        never turn one watchdog window into an unbounded hang and
        shutdown drains stay bounded by a chunk. ``progress`` (per-slot
        steps completed) fires after every chunk — the scheduler
        journals it as non-terminal progress acks. Returns the
        zero-arg ``collect`` yielding (chain, lnprob, naccept,
        rows_done) host arrays. Not recorded in the warm-restart store:
        a restored chain could not resume mid-run anyway (chunk state
        is not persisted; replay restarts the chain)."""
        from pint_tpu_torch.sampling.serve_kernel import (
            posterior_chunk_driver,
        )

        _, nb, pb, qb, W, K, thin = key[:7]
        stacked = stack_problems([r.problem for r in requests],
                                 shape=shape)
        # padded batch slots run a zero-step budget (their chunk
        # work is masked off, the all-padded GLS slot's convention)
        npad = shape[0] - len(requests)
        seeds = [r.seed for r in requests] + [0] * npad
        nsteps = [r.nsteps for r in requests] + [0] * npad
        fnv = self._posterior_kernel(W, K, thin)
        if info is None:
            info = {}
        inner = posterior_chunk_driver(
            fnv, stacked, seeds, nsteps, W, K, thin,
            device=self.device, sync=sync, progress=progress,
            supervisor=self.supervisor,
            key_tag="serve.posterior/" + "/".join(str(x) for x in key),
            pool=pool, info=info)

        def collect():
            out = inner()
            if info.get("used_pool") == "device":
                # compile accounting parity with gls/phase: the class
                # is recorded only after a real device dispatch
                self.keys.add(key)
            return out

        return collect

    def gwb_begin(self, key, requests, sync: bool = False,
                  pool: str = "device",
                  info: Optional[dict] = None, progress=None):
        """Sweep each request's (log10A, gamma) grid through the
        array-likelihood chunk driver (``pta.gwb.gwb_sweep_driver``):
        every chunk of K grid points is its own supervised,
        deadline-bounded dispatch with the numpy outer mirror as host
        failover, so the chunk boundary is the failover/drain
        boundary. ``progress(k, points_done)`` fires after each of
        request k's chunks. Returns the zero-arg ``collect`` yielding
        one logL host array per request.

        Batch coalescing here is ADMISSION coalescing only: each
        request owns its array (its own blocks, Gamma and basis), so
        same-class requests ride one sealed unit but sweep as
        separate chunked dispatches — under ``sync=False`` every
        request's chunk 0 is issued on the supervisor's pipeline, so
        the unit still overlaps device work."""
        from pint_tpu_torch.pta.gwb import gwb_sweep_driver

        K = key[3]
        if info is None:
            info = {}
        infos = [dict() for _ in requests]
        tag = "serve.gwb/" + "/".join(str(x) for x in key)
        collects = []
        for k, r in enumerate(requests):
            prog = None if progress is None else \
                (lambda done, k=k: progress(k, done))
            collects.append(gwb_sweep_driver(
                r.likelihood, r.log10A, r.gamma, K,
                supervisor=self.supervisor, key_tag=tag,
                pool=pool, sync=sync, info=infos[k],
                progress=prog))

        def collect():
            outs = [np.asarray(c()) for c in collects]
            pools = [i.get("used_pool") for i in infos]
            if "host-failover" in pools:
                info["used_pool"] = "host-failover"
            elif pools and all(p == "host" for p in pools):
                info["used_pool"] = "host"
            else:
                info["used_pool"] = "device"
                self.keys.add(key)
            return outs

        return collect


def _append_host(out) -> tuple:
    """The append program's read-back outputs with ``ok`` as bool and
    ``iters`` as int, the numpy mirror's types."""
    out = list(out)
    out[9] = out[9] > 0.5
    out[10] = out[10].astype(np.int64)
    return tuple(out)
