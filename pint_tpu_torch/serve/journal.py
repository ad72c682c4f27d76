"""Crash-safe restart: append-only request journal, the warm-restart
store of the serve shape classes, serve-state snapshot (a port of
pint_tpu/serve/journal.py).

- ``RequestJournal`` (host code, copied): an append-only JSONL journal.
  Every journalable admission (a request carrying a ``payload`` — an
  opaque JSON-able description the caller's replay factory can rebuild
  from) is recorded BEFORE dispatch and acknowledged with a status
  label (served / shed:* / failed) on completion; each line is flushed
  and fsynced so a SIGKILL loses at most the line being written. A cold
  restart reads the journal and replays exactly the entries without an
  ack (``ServeEngine.replay``).
- ``AotStore``: the reference serializes each shape class's compiled
  program with ``jax.export``. Eager torch compiles nothing, so there
  is no program to serialize: the store keeps the reference's manifest
  format and counters, and records each class's input shapes and
  dtypes (its avals) instead of a module. ``restore_all`` primes every
  compatible class on the engine's device, through the supervisor,
  with a masking-safe zero batch (every slot padded: valid = pvalid =
  0, unit nvec and phi). That builds the cuBLAS and cuSOLVER handles
  and the caching allocator's blocks of exactly those shapes before
  the first request, and a restored class's first request records no
  new class in ``compile_count``. The class programs are the same
  functions either way, so results are bitwise those of a cold
  engine. The manifest's fingerprint (torch version, CUDA version,
  device name, float64) skips entries from another card or build.
- ``save_state``/``load_state``: the serve-state snapshot
  (``state.json`` in the store's dir): metrics snapshot + shutdown
  reason, written on ``ServeEngine.stop`` so the restarted process can
  label itself warm/cold honestly in the ``restart`` block of its
  artifacts.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from pint_tpu_torch.runtime import locks
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["RequestJournal", "AotStore", "save_state", "load_state"]


# ------------------------------------------------------------------
# request journal
# ------------------------------------------------------------------


class RequestJournal:
    """Append-only JSONL request journal.

    Line forms::

        {"op": "admit", "rid": ..., "payload": {...}, "tenant": ...}
        {"op": "ack",   "rid": ..., "status": "served" | "shed:..." |
                                              "failed" | "replayed"}

    ``unacknowledged()`` returns admit records with no terminal ack,
    in admit order — the replay set. "replayed" is a progress marker
    (the restarted engine re-admitted the entry), not a terminal
    status; a crash DURING replay leaves the entry replayable again.

    **Fleet ownership protocol**: the journal doubles as
    the fleet's replicated log. Admit records may carry a
    ``"worker"`` owner; ``lease``/``heartbeat`` records register a
    worker and renew its lease (``workers()`` reads the newest
    heartbeat per worker); a ``rehome`` record transfers an admit's
    ownership to a survivor (applied at scan time, so
    ``unacknowledged(owner=...)`` — the per-worker replay set —
    always reflects the LAST recorded owner and a re-homed entry is
    never replayed twice by two workers)::

        {"op": "lease",     "worker": W, "t": ...}
        {"op": "heartbeat", "worker": W, "t": ...}
        {"op": "rehome",    "rid": ..., "worker": W}

    **Torn-record hardening**: a crash
    mid-append leaves a partial last line, and records interleaved
    around a ``compact()`` can leave stale bytes; every scan
    warn-and-skips any unparseable (or non-object) record — counted
    once per distinct record in ``pint_tpu_journal_torn_records`` —
    and NEVER raises: a damaged journal degrades to a smaller replay
    set, not a dead restart path.

    Long-running chunked work (a posterior chain) additionally writes
    ``progress`` lines between its chunk dispatches — non-terminal
    marks recording how far a request got before a crash. They are
    informational (replay restarts the chain from scratch — chunk
    results are not persisted) and are dropped by compaction.

    **Compaction**: an append-only journal on a
    long-lived deployment grows without bound even though the replay
    set stays tiny. ``compact()`` rewrites the file to exactly the
    unacknowledged admit records (original lines verbatim, admit
    order preserved) via atomic tmp + fsync + rename — a crash
    mid-compaction leaves the previous journal intact, and replay
    after compaction is bit-identical to replay before it
    (tests/test_serve_restart.py). Auto-triggered after an append
    pushes the file past ``config.journal_compact_bytes()``
    ($PINT_TPU_JOURNAL_COMPACT_BYTES, 0 disables).
    """

    _TERMINAL = ("served", "failed", "shed")

    def __init__(self, path: str,
                 compact_bytes: Optional[int] = None):
        from pint_tpu_torch.obs import metrics as om

        self.path = path
        self._lock = locks.make_lock("serve.journal")
        self._fh = None
        # compaction count rides the metric registry (the
        # counts() dict reads it back — derived view, G13-clean)
        _scope = om.new_scope("journal")
        self._c_compactions = om.counter(
            "pint_tpu_journal_compactions_total",
            "journal auto/explicit compactions"
        ).child(scope=_scope)
        # unparseable records warn-and-skip at
        # scan, counted once per distinct damaged line (scans repeat;
        # the damage does not)
        self._c_torn = om.counter(
            "pint_tpu_journal_torn_records",
            "unparseable journal records skipped at scan"
        ).child(scope=_scope)
        self._torn_seen: set = set()
        if compact_bytes is None:
            from pint_tpu_torch import config

            compact_bytes = config.journal_compact_bytes()
        self._compact_bytes = max(0, int(compact_bytes))
        self._next_compact = self._compact_bytes
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        # a crash mid-write leaves a torn tail line WITHOUT a
        # newline; appending straight onto it would concatenate the
        # next record into the unparseable tail and lose BOTH
        torn = False
        try:
            with open(path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() > 0:
                    fh.seek(-1, os.SEEK_END)
                    torn = fh.read(1) != b"\n"
        except OSError:
            pass
        self._fh = open(path, "a", encoding="utf-8")
        if torn:
            self._fh.write("\n")
            self._fh.flush()
        self._bytes = self._fh.tell()

    # -- writes --------------------------------------------------------

    def _append(self, rec: dict):
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._fh is None or self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._bytes += len(line) + 1
            if self._compact_bytes and self._bytes > self._next_compact:
                self._compact_locked()

    def admit(self, rid: str, payload: dict,
              tenant: Optional[str] = None,
              deadline_s: Optional[float] = None,
              worker: Optional[str] = None):
        rec = {"op": "admit", "rid": rid, "payload": payload}
        if tenant is not None:
            rec["tenant"] = tenant
        if deadline_s is not None:
            rec["deadline_s"] = deadline_s
        if worker is not None:
            rec["worker"] = worker
        self._append(rec)

    def ack(self, rid: str, status: str):
        self._append({"op": "ack", "rid": rid, "status": status})

    # -- fleet ownership ------------------------------------

    def lease(self, worker: str):
        """Register ``worker`` as a fleet member (first heartbeat)."""
        self._append({"op": "lease", "worker": worker,
                      "t": time.time()})

    def heartbeat(self, worker: str):
        """Renew ``worker``'s lease. The fleet front's expiry sweep
        compares the newest heartbeat per worker against the lease
        TTL — a worker whose beats stop (killed OR partitioned from
        the journal) reads as expired and its unacked admits are
        re-homed."""
        self._append({"op": "heartbeat", "worker": worker,
                      "t": time.time()})

    def rehome(self, rid: str, worker: str):
        """Transfer ownership of one admit to ``worker``. Applied at
        scan time (last rehome wins), so the per-owner replay set
        moves with the record and survives compaction."""
        self._append({"op": "rehome", "rid": rid, "worker": worker})

    def progress(self, rid: str, steps: int):
        """Non-terminal progress mark for chunked work (a posterior
        chain records steps completed after every chunk dispatch):
        visible in a post-crash journal scan, dropped by compaction,
        ignored by the replay-set computation."""
        self._append({"op": "progress", "rid": rid,
                      "steps": int(steps)})

    # -- compaction ----------------------------------------------------

    def compact(self):
        """Rewrite the journal to exactly its unacknowledged admit
        records (atomic tmp + fsync + rename; original admit lines
        preserved verbatim and in order, so replay after compaction
        is bit-identical to replay before it)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self):
        keep = self.unacknowledged_unlocked()
        # fleet liveness survives compaction: one heartbeat record
        # per leased worker at its newest recorded time
        _, _, beats = self._scan()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in keep:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
            for w in sorted(beats):
                fh.write(json.dumps(
                    {"op": "heartbeat", "worker": w, "t": beats[w]},
                    sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        reopen = self._fh is not None and not self._fh.closed
        if reopen:
            self._fh.close()
        self._fh = open(self.path, "a", encoding="utf-8")
        self._bytes = self._fh.tell()
        if not reopen:
            # compacting a closed journal leaves it closed
            self._fh.close()
        self._c_compactions.inc()
        # hysteresis: when the LIVE unacknowledged set itself exceeds
        # the threshold, compaction cannot shrink below it — without
        # a backoff every subsequent append would re-scan and rewrite
        # the whole file under the lock (O(file) per append during
        # exactly the backed-up outage this journal exists for). The
        # next auto-trigger waits for the file to double instead.
        if self._compact_bytes:
            self._next_compact = max(self._compact_bytes,
                                     2 * self._bytes)

    @property
    def compactions(self) -> int:
        return int(self._c_compactions.value())

    def close(self):
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()

    # -- reads ---------------------------------------------------------

    def _torn_locked(self, line: str):
        """Count one unparseable record, once per distinct line —
        scans repeat every restart/compaction; the damage does not.
        Warn-and-skip, NEVER raise."""
        h = hashlib.sha256(line.encode("utf-8", "replace")).digest()
        if h in self._torn_seen:
            return
        self._torn_seen.add(h)
        self._c_torn.inc()
        _log().warning("journal %s: skipping torn/unparseable "
                       "record (%d bytes)", self.path, len(line))

    def _scan(self) -> Tuple[List[dict], Dict[str, str],
                             Dict[str, float]]:
        """One pass over the file: (admits with ownership rehomes
        applied, terminal acks by rid, newest heartbeat per worker).
        Callers hold ``self._lock`` (scan races auto-compaction's
        rewrite+rename otherwise)."""
        admits: List[dict] = []
        acks: Dict[str, str] = {}
        beats: Dict[str, float] = {}
        rehomes: Dict[str, str] = {}
        try:
            with open(self.path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        self._torn_locked(line)
                        continue
                    if not isinstance(rec, dict):
                        # parses but is not a record (a bare scalar
                        # from interleaved torn writes)
                        self._torn_locked(line)
                        continue
                    op = rec.get("op")
                    if op == "admit":
                        admits.append(rec)
                    elif op == "ack":
                        st = str(rec.get("status", ""))
                        if st.split(":", 1)[0] in self._TERMINAL:
                            acks[rec.get("rid")] = st
                    elif op in ("lease", "heartbeat"):
                        w = rec.get("worker")
                        if w is not None:
                            try:
                                t = float(rec.get("t", 0.0))
                            except (TypeError, ValueError):
                                t = 0.0
                            beats[w] = max(beats.get(w, 0.0), t)
                    elif op == "rehome":
                        rid, w = rec.get("rid"), rec.get("worker")
                        if rid is not None and w is not None:
                            rehomes[rid] = w
        except OSError:
            pass
        if rehomes:
            # last recorded owner wins; applied to a COPY so the
            # verbatim admit line is what compaction re-serializes
            # only when ownership did not move
            admits = [
                dict(rec, worker=rehomes[rec.get("rid")])
                if rec.get("rid") in rehomes else rec
                for rec in admits]
        return admits, acks, beats

    def unacknowledged_unlocked(
            self, owner: Optional[str] = None) -> List[dict]:
        admits, acks, _ = self._scan()
        seen = set()
        out = []
        for rec in admits:
            rid = rec.get("rid")
            if rid in acks or rid in seen:
                continue
            seen.add(rid)
            if owner is not None and rec.get("worker") != owner:
                continue
            out.append(rec)
        return out

    def unacknowledged(self,
                       owner: Optional[str] = None) -> List[dict]:
        # under the lock so a concurrent auto-compaction's
        # rewrite+rename never races the scan. ``owner`` filters to
        # one worker's replay set (fleet re-home path).
        with self._lock:
            return self.unacknowledged_unlocked(owner)

    def workers(self) -> Dict[str, float]:
        """Newest heartbeat time per leased worker."""
        with self._lock:
            _, _, beats = self._scan()
            return beats

    def counts(self) -> dict:
        with self._lock:
            admits, acks, beats = self._scan()
            unacked = len(self.unacknowledged_unlocked())
            return {"admitted": len(admits), "acked": len(acks),
                    "unacknowledged": unacked,
                    "compactions": self.compactions,
                    "torn": int(self._c_torn.value()),
                    "workers": len(beats),
                    "bytes": self._bytes}


# ------------------------------------------------------------------
# AOT executable store
# ------------------------------------------------------------------


def _fingerprint(device=None) -> dict:
    """The configuration a class entry is only valid under."""
    import torch

    dev = torch.device("cpu" if device is None else device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": name, "dtype": "float64"}


def _key_str(kind: str, full_key: tuple) -> str:
    return kind + "/" + "/".join(str(x) for x in full_key)


class AotStore:
    """Warm-restart store of one engine's shape classes.

    ``save(kind, full_key, program, avals)`` records a class that
    completed a real device dispatch: its key, the name of its program
    and the shapes and dtypes of its inputs, atomically in the
    manifest. ``restore_all(supervisor, primers)`` primes every
    manifest entry matching the current configuration with a
    masking-safe zero batch (``primers[kind](avals)`` runs the class
    program on the device) and marks it restored; ``get`` returns the
    restored program of a class, counting hits and misses."""

    _COUNTERS = ("exported", "export_errors", "restore_errors",
                 "hits", "misses")

    def __init__(self, dirpath: str, donation: bool = False,
                 device=None):
        from pint_tpu_torch.obs import metrics as om

        self.dir = dirpath
        self.donation = bool(donation)
        self.device = device
        os.makedirs(dirpath, exist_ok=True)
        self._manifest_path = os.path.join(dirpath, "manifest.json")
        self._restored: Dict[str, Callable] = {}
        self._saved: set = set()
        self._lock = locks.make_lock("serve.aot_store")
        # registry-backed counters (scope-labelled), read back via
        # __getattr__ — snapshot() stays a derived view; hits/misses
        # count restored-class lookups at dispatch time (the
        # warm-restart effectiveness gauge)
        self._scope = om.new_scope("aot")
        self._c = {
            name: om.counter(
                f"pint_tpu_aot_{name}_total",
                f"AOT store {name.replace('_', ' ')}"
            ).child(scope=self._scope)
            for name in self._COUNTERS}
        self._g_restored = om.gauge(
            "pint_tpu_aot_restored",
            "restored shape classes held").child(scope=self._scope)
        self.restored = 0

    def __getattr__(self, name):
        c = self.__dict__.get("_c")
        if c is not None and name in type(self)._COUNTERS:
            return int(c[name].value())
        raise AttributeError(name)

    # -- manifest ------------------------------------------------------

    def _read_manifest(self) -> dict:
        try:
            with open(self._manifest_path, encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError):
            return {}

    def _write_manifest(self, manifest: dict):
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._manifest_path)

    # -- export --------------------------------------------------------

    def has(self, kind: str, full_key: tuple) -> bool:
        ks = _key_str(kind, full_key)
        with self._lock:
            return ks in self._saved or ks in self._restored

    def save(self, kind: str, full_key: tuple, program, avals):
        """Record one class (``avals``: ((shape, dtype), ...) of its
        inputs). Failures are counted, never raised: the store is an
        optimization, losing an entry must not fail the dispatch that
        just succeeded."""
        ks = _key_str(kind, full_key)
        with self._lock:
            if ks in self._saved or ks in self._restored:
                return
            self._saved.add(ks)  # one attempt per key, even on error
        try:
            entry = {
                "kind": kind,
                "key": list(full_key),
                "program": getattr(program, "__qualname__",
                                   str(program)),
                "avals": [[list(shape), str(dtype)]
                          for shape, dtype in avals],
                "donation": self.donation,
                **_fingerprint(self.device),
            }
            with self._lock:
                manifest = self._read_manifest()
                manifest[ks] = entry
                self._write_manifest(manifest)
            self._c["exported"].inc()
        except Exception as e:
            self._c["export_errors"].inc()
            _log().warning("AOT record of %s failed: %r", ks, e)

    # -- restore -------------------------------------------------------

    def restore_all(self, supervisor=None, primers=None) -> int:
        """Prime every compatible class and mark it restored. Returns
        the number restored. ``primers`` maps a kind to
        ``fn(avals) -> program`` (it runs the program once on a zero
        batch and returns it); the whole pass is one
        ``supervisor.dispatch`` on the store's device, so a wedged card
        degrades to a cold engine rather than hanging construction.
        Without a primer a kind is skipped; any per-entry failure skips
        that entry."""
        manifest = self._read_manifest()
        if not manifest or not primers:
            return 0
        fp = _fingerprint(self.device)
        compatible = {
            ks: ent for ks, ent in manifest.items()
            if all(ent.get(k) == v for k, v in fp.items())
            and bool(ent.get("donation", False)) == self.donation
            and ent.get("kind") in primers}
        if not compatible:
            return 0

        def _primed():
            restored = {}
            for ks, ent in compatible.items():
                try:
                    avals = [(tuple(shape), dtype)
                             for shape, dtype in ent["avals"]]
                    restored[ks] = primers[ent["kind"]](avals)
                except Exception as e:
                    self._c["restore_errors"].inc()
                    _log().warning("AOT restore of %s failed: %r",
                                   ks, e)
            return restored

        try:
            if supervisor is not None:
                from pint_tpu_torch import obs

                with obs.span("serve.aot_restore",
                              n=len(compatible)):
                    restored = supervisor.dispatch(
                        _primed, key="serve.aot_restore",
                        device=self.device, fallback=lambda: {})
            else:
                restored = _primed()  # graftlint: allow G6 -- a store built without a supervisor (tests, tools) primes in the caller's thread; ServeEngine always passes its supervisor
        except Exception as e:
            self._c["restore_errors"].inc()
            _log().warning("AOT restore pass failed: %r", e)
            restored = {}
        with self._lock:
            self._restored.update(restored)
            self.restored = len(self._restored)
            self._g_restored.set(self.restored)
        # restored classes are programs this process primed instead of
        # learning them from traffic: the ledger records them with
        # aot_restored=True (key spelled as the scheduler's dispatch
        # key, so a later first call merges into the same entry)
        try:
            from pint_tpu_torch.obs import perf as _perf
            from pint_tpu_torch.runtime import backend_of

            for ks in restored:
                _perf.note_compile(f"serve.{ks}",
                                   backend=backend_of(self.device),
                                   kind="aot", aot_restored=True)
        except Exception:
            pass
        return self.restored

    def get(self, kind: str, full_key: tuple) -> Optional[Callable]:
        with self._lock:
            fn = self._restored.get(_key_str(kind, full_key))
        # restore hit/miss accounting: a dispatch-time lookup that
        # finds a restored class is a warm-restart win; a miss is a
        # class this process learned itself
        self._c["hits" if fn is not None else "misses"].inc()
        return fn

    def snapshot(self) -> dict:
        with self._lock:
            restored = self.restored
        return {"dir": self.dir,
                "restored": restored,
                "exported": self.exported,
                "export_errors": self.export_errors,
                "restore_errors": self.restore_errors,
                "hits": self.hits,
                "misses": self.misses}


# ------------------------------------------------------------------
# serve-state snapshot
# ------------------------------------------------------------------


def save_state(dirpath: str, snapshot: dict,
               reason: str = "shutdown"):
    """Write the serve-state snapshot (``state.json`` in the AOT
    dir): the engine metrics snapshot + shutdown reason. Atomic, so
    a crash mid-write leaves the previous snapshot intact."""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, "state.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"reason": reason, "metrics": snapshot}, fh,
                  indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_state(dirpath: str) -> Optional[dict]:
    try:
        with open(os.path.join(dirpath, "state.json"),
                  encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def _log():
    from pint_tpu_torch.logging import log

    return log
