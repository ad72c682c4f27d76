"""Declared lock discipline — the registry graftlint G16 checks the
port's serve/dispatch/runtime/obs layers against (a port of
pint_tpu/analysis/lock_registry.py: the same 21 entries, over the
port's serve/scheduler.py, admission.py, journal.py, fleet.py and
obs/metrics.py, which keep the reference's classes, fields and locks).

Policy: the serve stack's
concurrency contracts — "MetricsServer never takes an engine lock",
"no dispatch under the engine lock", "journal fsync outside the cv"
— were each asserted by one hand-written test. This registry makes
them DECLARED state, the precision_registry.py pattern: every entry
carries a written justification, stale entries fail the lint run, and
graftlint G16 statically enforces three properties:

1. **guarded-field writes** (``GUARDED``): a registered field may be
   written only in ``__init__``, in a ``*_locked``-suffixed method
   (the repo's caller-holds-the-lock naming convention), in one of
   the entry's declared ``holders`` methods, or lexically inside
   ``with self.<lock>``. Anything else is an unsynchronized write to
   state another thread reads under the lock.
2. **scrape-path isolation** (``SCRAPE_ROOTS``): the functions listed
   here must be statically unreachable from any acquisition of a
   registry-listed engine lock — the repo-wide proof behind
   tests/test_metrics.py's "scrape never blocks on the engine lock".
3. **no blocking ops under an engine lock** (``ENGINE_LOCKS`` +
   ``BLOCKING_CALLS``): no supervised dispatch, journal fsync/admit,
   or host solve may run lexically inside a ``with`` on a listed
   engine lock. The scheduler's ``_dispatch_lock`` is deliberately
   NOT listed: it is the dispatch serializer — sealed units issue
   and collect while holding it BY DESIGN, with ``_cv`` released per
   iteration so admission keeps flowing.

The dynamic half (``runtime.locks`` TracedLock, $PINT_TPU_LOCK_TRACE)
checks the same discipline at runtime: ``engine=True`` lock
constructions must agree with ``ENGINE_LOCKS`` here.

Entry fields (GUARDED):
  file     repo-relative path
  cls      owning class name
  field    the guarded attribute (``self.<field>`` writes checked)
  lock     the owning lock attribute; writes must sit inside
           ``with self.<lock>`` (aliases: a Condition built over the
           lock counts — declare it via ``aliases``)
  aliases  additional attribute names whose ``with`` also proves the
           lock held (e.g. ``_cv`` wraps ``_lock``)
  holders  methods allowed to write OUTSIDE a lexical ``with``
           because their ONLY callers hold the lock (each must be
           justified in ``why``)
  why      mandatory justification

A GUARDED entry that matches no write anywhere is stale and fails
the run — the registry cannot rot into a blanket waiver.
"""

# ---------------------------------------------------------------- G16.1
GUARDED = [
    # ------------------------------------------ serve scheduler queue
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_open", lock="_lock", aliases=("_cv",), holders=(),
         why="open-bucket table: submit inserts, the seal/expiry "
             "sweeps and _shed_remaining clear — all under the cv "
             "(or in *_locked helpers whose callers hold it); the "
             "drain loop re-acquires the cv per iteration to pop."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_ready", lock="_lock", aliases=("_cv",), holders=(),
         why="sealed-unit deque between submit (seal under cv) and "
             "the drain loop (popleft under cv, per iteration)."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_nqueued", lock="_lock", aliases=("_cv",), holders=(),
         why="queue depth: capacity checks and the shed policy read "
             "it under the cv; every increment/decrement (admit, "
             "expiry, drain pop, shutdown shed) must hold the cv or "
             "two concurrent submits double-admit past queue_cap."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_earliest_expiry", lock="_lock", aliases=("_cv",),
         holders=(),
         why="amortizes the expiry sweep (skip until due); written "
             "on admit and by _expire_locked, both under the cv."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_drain_stop_at", lock="_lock", aliases=("_cv",),
         holders=("stop",),
         why="shutdown drain bound. stop() writes it BEFORE taking "
             "the cv on purpose: it is a monotonic one-way latch "
             "(None -> a bound, never back) read by the drain loop "
             "under the cv — the benign pre-signal write means a "
             "drain already past the read still gets bounded by the "
             "per-iteration re-read; holding the cv for the write "
             "would add nothing but a stall behind a full sweep."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_dead", lock="_dispatch_lock", holders=(),
         why="kill_restart latch (False -> True, never back): set "
             "by the drain loop while it holds _dispatch_lock; "
             "submit/loop read it opportunistically — a stale read "
             "admits one more request whose future then fails, the "
             "documented crash semantics (journal replay covers it)."),
    dict(file="pint_tpu_torch/serve/scheduler.py", cls="ServeEngine",
         field="_pool_last_collect", lock="_dispatch_lock",
         holders=("_dispatch_finish",),
         why="per-pool last-collect stamp feeding the router's "
             "inter-completion rate sample. Written only in "
             "_dispatch_finish, whose every call site sits inside "
             "_drain_ready's `with self._dispatch_lock:` block — a "
             "holder, not a lexical with (the lock is the caller's)."),
    # --------------------------------------------- admission control
    dict(file="pint_tpu_torch/serve/admission.py", cls="AdmissionController",
         field="_buckets", lock="_lock", holders=(),
         why="tenant -> TokenBucket table: check_quota's get-or-"
             "create + drain + take must be atomic per tenant or a "
             "burst races two buckets into existence."),
    dict(file="pint_tpu_torch/serve/admission.py", cls="AdmissionController",
         field="_shed_times", lock="_lock", holders=(),
         why="burst-detector deque: append + window test + clear "
             "are one atomic decision in note_shed — a torn window "
             "double-fires the shed-burst flight dump."),
    dict(file="pint_tpu_torch/serve/admission.py", cls="AdmissionController",
         field="_tenant_names", lock="_lock",
         holders=("_note_tenant",),
         why="name set behind the derived `tenants` view. "
             "_note_tenant's docstring declares 'caller holds "
             "self._lock' and both call sites (check_quota) do — a "
             "holder by convention, enforced here."),
    # ------------------------------------------------ request journal
    dict(file="pint_tpu_torch/serve/journal.py", cls="RequestJournal",
         field="_fh", lock="_lock", holders=(),
         why="journal file handle: swapped by _compact_locked's "
             "atomic rewrite while _append writes through it — an "
             "unlocked swap loses the record being appended."),
    dict(file="pint_tpu_torch/serve/journal.py", cls="RequestJournal",
         field="_bytes", lock="_lock", holders=(),
         why="running file size driving auto-compaction; updated "
             "per append and reset by the compaction rewrite."),
    dict(file="pint_tpu_torch/serve/journal.py", cls="RequestJournal",
         field="_next_compact", lock="_lock", holders=(),
         why="compaction hysteresis threshold, written only by "
             "_compact_locked (suffix convention) after a rewrite."),
    dict(file="pint_tpu_torch/serve/journal.py", cls="RequestJournal",
         field="_torn_seen", lock="_lock", holders=(),
         why="damaged-record dedup set behind the torn-record "
             "counter: written only in __init__ and "
             "_torn_locked (suffix convention — every _scan caller "
             "holds the journal lock); an unlocked add double-counts "
             "a torn line against a concurrent compaction scan."),
    # ------------------------------------------------ serve fleet
    dict(file="pint_tpu_torch/serve/fleet.py", cls="FleetFront",
         field="_state", lock="_lock", holders=(),
         why="worker lifecycle latch (live -> dead -> rehomed): the "
             "sweep's fence + re-home transition and submit's "
             "live-set pick must observe it atomically, or two "
             "sweeps re-home the same dead worker's admits twice "
             "(double-replay = double-serve)."),
    dict(file="pint_tpu_torch/serve/fleet.py", cls="FleetFront",
         field="_rr", lock="_lock", holders=(),
         why="round-robin cursor behind the live-worker pick; torn "
             "increments skew placement, harmless but the lock is "
             "already held for the live-set read."),
    dict(file="pint_tpu_torch/serve/fleet.py", cls="FleetFront",
         field="_inflight", lock="_lock", holders=(),
         why="rid -> original-request map the re-home pass resolves "
             "survivor results into: insert (submit track), pop "
             "(future done callback) and the re-home lookup run on "
             "three different threads."),
]

# ---------------------------------------------------------------- G16.3
# Engine/scheduler locks: admission-critical — every submitter
# serializes on them, so a blocking operation held under one stalls
# the whole deployment's admission path. The dynamic mirror is
# ``engine=True`` in the runtime.locks construction.
ENGINE_LOCKS = [
    dict(file="pint_tpu_torch/serve/scheduler.py",
         attrs=("_lock", "_cv"),
         why="THE engine lock (the cv wraps it): submit, the seal/"
             "expiry sweeps and the serve loop all serialize here. "
             "A supervised dispatch (0.1-0.25 s RTT), a journal "
             "fsync, or a host solve under it turns one slow unit "
             "into a full admission stall — the tail-latency bug "
             "class G16 part 3 + check_dispatch_clear() exist for. "
             "_dispatch_lock is deliberately absent: dispatch under "
             "it IS the design (one drain at a time)."),
]

# Blocking operations banned inside `with <engine lock>` (tail names
# of the call). dispatch/dispatch_async = supervised device dispatch
# (runtime.supervisor); fsync + the journal's admit/ack/progress =
# fsynced disk writes (scheduler.submit journals OUTSIDE the cv on
# purpose); pta_solve_np = the host GLS mirror (seconds at scale).
BLOCKING_CALLS = frozenset({
    "dispatch", "dispatch_async", "fsync",
    "admit", "ack", "progress", "pta_solve_np",
})

# ---------------------------------------------------------------- G16.2
# Scrape-path roots: must be statically unreachable from any
# ENGINE_LOCKS acquisition (BFS over the resolvable call graph —
# same-class self.* calls, same-module calls, imported-module
# attribute calls).
SCRAPE_ROOTS = [
    dict(file="pint_tpu_torch/obs/metrics.py", func="do_GET",
         why="the MetricsServer handler: /metrics renders the "
             "registry (per-metric locks only) and /healthz calls "
             "the health fn — the 'scrape never takes an engine "
             "lock' contract the serve tests assert by holding "
             "eng._lock while scraping."),
    dict(file="pint_tpu_torch/obs/metrics.py", func="default_health",
         why="the /healthz payload builder: breaker snapshots, SLO "
             "watchdog status, numerics verdicts — all process-"
             "global obs state with its own leaf locks."),
    dict(file="pint_tpu_torch/serve/admission.py", func="snapshot",
         why="the admission block of every serve snapshot; "
             "documented lock-free over registry reads (its own "
             "_lock guards only the tenant name set) so a snapshot "
             "never serializes behind the admission hot path."),
]

# Raw threading primitives (G16 sub-check): construction of
# threading.Lock/RLock/Condition in the dispatch/serve/runtime/obs
# layers must go through runtime.locks factories so the traced build
# sees every lock. Sanctioned raw sites carry a G16 pragma with a
# written justification (runtime/locks.py's own internals).


def entry_count() -> int:
    """Registry size (the lint CLI smoke test asserts it is > 0 and
    tests pin drift, the precision_registry pattern)."""
    return len(GUARDED) + len(ENGINE_LOCKS) + len(SCRAPE_ROOTS)
