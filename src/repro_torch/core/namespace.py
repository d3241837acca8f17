"""Durable namespace subsystem: logged metadata operations with
crash-consistent create/rename/unlink/ftruncate.

Why this exists (paper §IV, §II)
--------------------------------
The paper's headline experiments run *unmodified legacy applications* —
SQLite and RocksDB — over NVCache.  Both derive their crash consistency
from **metadata** protocols, not data writes: SQLite's rollback-journal
commit point is the *unlink* of the journal (and WAL mode resets the WAL
with a truncate), while RocksDB installs a new MANIFEST by *renaming* it
into place.  A data-plane-only cache (paper §II: the write log holds file
bytes) lets a crash lose a create/rename/unlink the application already
observed as durable, silently breaking those protocols.  NVLog
(arXiv:2408.02911) journals exactly these operations in NVM for the same
reason.

Design
------
The namespace owns the path→fdid map (the paper's §III "file table",
previously inline in :class:`repro.core.api.NVCache`) and persists every
namespace mutation as a first-class NVMM log entry
(:data:`repro.core.log.META_FDID`, ops ``MOP_CREATE``/``MOP_RENAME``/
``MOP_UNLINK``/``MOP_FTRUNCATE``) committed through the **same per-shard
alloc/fill/commit protocol as data writes** (paper §II-D).  Because the
global commit ``seq`` is drawn inside the shard allocation lock, the
cross-shard seq-merge that recovery already performs totally orders every
metadata op against every data group, and replaying the union in ascending
seq rebuilds the namespace exactly as the application observed it.

The per-op commit protocol maps onto the paper's §II guarantees:

* **Synchronous durability** (§II, Table III): the metadata record is
  committed in the NVMM log — followers, pwb, head commit flag, psync —
  *before* the backend (slow-tier) namespace is touched and before the
  call returns.  An acknowledged rename/unlink survives any crash.
* **Durable linearizability** (§III): the caller first quiesces the file
  behind the shared drain barrier (the one close/O_TRUNC/route-migration
  already use), so every covered data entry has a smaller ``seq`` and has
  already drained; writes after the op observe the new namespace.  The
  recovery merge therefore can never attribute renamed data to the old
  name or resurrect an unlinked file's bytes.
* **Old-or-new, never torn**: the record commits atomically through the
  entry group's head commit flag (one 8-byte store), and recovery drops a
  torn group *whole* (the PR-4 rule).  A crash at any point leaves the
  namespace in the pre-op or post-op state — exactly the atomicity the
  legacy protocols assume of the kernel.

Drain coordination
------------------
Between "record committed in the log" and "backend effect applied" the
entry must not be retired — a crash in that window must still replay the
op.  The namespace registers a **not-yet-applied marker** for the entry in
:meth:`Namespace.journal_locked`'s pre-commit ``on_alloc`` hook (the same trick
the dirty-page index uses, so the drain can never observe the entry
without its marker) and clears it in :meth:`Namespace.mark_applied` once
the backend namespace mutation is done.  The drain
(:meth:`repro.core.cleanup.CleanupThread._consume_batch`) stops a batch
short of the first still-marked metadata entry and retries — deletes and
backend renames are thus consumed only after they are both *covered*
(barrier) and *applied*.  Recovery replays a still-logged op idempotently.

Deferred backend apply
----------------------
``rename`` used to apply its backend effect synchronously under the
file-table lock, stalling every racing namespace op behind a slow-tier
directory update.  It now journals under the lock and enqueues the apply
(:meth:`Namespace.queue_apply`); the queue is drained FIFO by
:meth:`Namespace.apply_deferred` — called by the renaming thread itself
right after releasing the lock (so the backend is current by the time the
call returns), by any namespace op that is about to consult backend state,
and by the drain threads whenever an unapplied record blocks a batch (the
drain's meta-apply path: progress never depends on the original caller).
Applying is idempotent to re-entry because the queue pops under its own
lock and each apply runs exactly once.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import locking
from repro_torch.core.log import (MOP_CREATE, MOP_FTRUNCATE, MOP_RENAME,
                            MOP_UNLINK, NVLog, encode_meta)

__all__ = ["Namespace", "MOP_CREATE", "MOP_RENAME", "MOP_UNLINK",
           "MOP_FTRUNCATE"]

#: generous bound for metadata appends: a namespace op behind a full log
#: waits for the drain like any writer, but must not hang forever
META_APPEND_TIMEOUT = 30.0


class Namespace:
    """The path→fdid map plus the metadata journaling protocol.

    ``lock`` is the file-table lock (what :class:`~repro.core.api.NVCache`
    historically called ``_meta``); the owner takes it around every
    file-table mutation, including the journal+apply step of a namespace
    op, so a concurrent ``open`` can never slip between an unlink's
    journal record and its backend effect.
    """

    GUARDED_BY = {
        # mutated only under ``lock`` (the *_locked helpers); read lock-free
        # by the drain's resolve and by existence probes — safe because a
        # file with pending entries is never unbound, so any binding the
        # drain observes is stable
        "files": "write:lock", "by_fdid": "write:lock",
        "fdid_free": "lock",
        # journaled-record markers: mutated under _ua_lock (the _consumed
        # condition shares it); has_unapplied's lock-free read is a cheap
        # maybe-stale pre-check by design, hence write-only
        "_unapplied": "write:_ua_lock",
        "_live": ("_ua_lock", "_consumed"),
        # append under the caller-held meta lock, popleft under _apply_lock;
        # deque ops are individually atomic and FIFO order is preserved
        "_deferred": locking.VOLATILE,
        "stats_meta_ops": "lock", "stats_meta_entries": "lock",
        "stats_deferred_applies": "_apply_lock",
    }

    def __init__(self, log: NVLog, tier, fd_max: int):
        self.log = log
        self.tier = tier
        self.lock = locking.make_lock("meta")
        # guarded-by: write:lock — see GUARDED_BY for the read-side story
        self.files: Dict[str, object] = {}       # path -> api.File
        self.by_fdid: Dict[int, object] = {}
        self.fdid_free: List[int] = list(range(fd_max - 1, -1, -1))
        #                                          guarded-by: lock
        self._unapplied: Set[Tuple[int, int]] = set()  # {(sid, idx)}
        #                                guarded-by: write:_ua_lock
        self._live: Set[Tuple[int, int]] = set()       # journaled, not yet
        #                                                consumed by the
        #                                                drain; guarded-by:
        #                                                _ua_lock/_consumed
        self._ua_lock = locking.make_lock("leaf:ns_unapplied")
        self._consumed = locking.make_condition("leaf:ns_unapplied", self._ua_lock)
        self._deferred = collections.deque()      # (seq, fn, marks) FIFO
        #                                           guarded-by: volatile
        self._apply_lock = locking.make_lock("leaf:ns_apply")  # serializes appliers
        self.stats_meta_ops = {"create": 0, "rename": 0, "unlink": 0,
                               "ftruncate": 0}    # guarded-by: lock
        self.stats_meta_entries = 0               # log entries appended
        #                                           guarded-by: lock
        self.stats_deferred_applies = 0           # queued backend applies
        #                                           run; guarded-by:
        #                                           _apply_lock

    # ------------------------------------------------------------ journal
    def journal_locked(self, op: int, fdid: int, aux: int, a: str,
                       b: str = "") -> Tuple[List[Tuple[int, int]], int]:
        """Durably commit one metadata record; returns ``(marks, seq)``.
        Caller holds :attr:`lock` (every namespace op journals inside its
        file-table critical section — that is what keeps a concurrent open
        from slipping between journal record and backend effect).
        The caller applies the backend effect, then calls
        :meth:`note_backend_applied` with ``seq`` and (in a ``finally``)
        :meth:`mark_applied` with ``marks``.  The markers are registered
        pre-commit, so there is no window in which the drain could retire
        the record before the effect lands."""
        payload = encode_meta(op, fdid, aux, a, b)
        marks: List[Tuple[int, int]] = []

        def on_alloc(sid: int, head: int, k: int, seq: int) -> None:
            with self._ua_lock:
                for j in range(k):
                    self._unapplied.add((sid, head + j))
                    self._live.add((sid, head + j))
                    marks.append((sid, head + j))

        _sid, _head, k, seq = self.log.append_meta(
            payload, route_key=a, timeout=META_APPEND_TIMEOUT,
            on_alloc=on_alloc)
        self.stats_meta_entries += k
        name = {MOP_CREATE: "create", MOP_RENAME: "rename",
                MOP_UNLINK: "unlink", MOP_FTRUNCATE: "ftruncate"}[op]
        self.stats_meta_ops[name] += 1
        return marks, seq

    def snapshot_stats(self) -> dict:
        """Coherent copy of the metadata counters for api.stats(): each
        counter is read under its own guard, never bare."""
        with self.lock:
            ops = dict(self.stats_meta_ops)
            entries = self.stats_meta_entries
        with self._apply_lock:
            deferred = self.stats_deferred_applies
        return {"meta_ops": ops, "meta_entries": entries,
                "deferred_applies": deferred}

    def note_backend_applied(self, seq: int) -> None:
        """Advance the backend's **applied watermark**: the tier records
        (durably, as part of applying — a journaling filesystem's dir
        update) the seq of the last namespace op reflected in it.  Recovery
        replays only ops ABOVE the surviving watermark: replaying an
        already-applied rename/unlink against a backend whose state has
        moved past it is not idempotent (a re-created source would be
        dragged over the destination, a re-created path unlinked again) —
        the watermark is what makes namespace replay old-or-new instead.

        Monotone under the lock: two ops whose applies interleave (an
        ftruncate racing an unlink of another file) must never let the
        lower seq overwrite the higher one — a regressed watermark would
        make recovery re-apply an op the backend already moved past."""
        with self._ua_lock:
            if seq > getattr(self.tier, "ns_seq", 0):
                self.tier.ns_seq = seq

    def mark_applied(self, marks: List[Tuple[int, int]]) -> None:
        """The backend namespace effect of a journaled op is applied (and,
        in the device model, durable): the drain may now consume it."""
        with self._ua_lock:
            self._unapplied.difference_update(marks)

    # ------------------------------------------------------ deferred apply
    def queue_apply(self, seq: int, fn, marks: List[Tuple[int, int]]) -> None:
        """Enqueue a journaled op's backend effect (see the module
        docstring).  The record's unapplied markers stay set until the
        apply runs, so the drain cannot retire it early."""
        self._deferred.append((seq, fn, marks))

    def apply_deferred(self) -> int:
        """Run every queued backend apply, FIFO; returns how many ran.
        Safe from any thread (appliers serialize on ``_apply_lock``); an
        apply that raises still advances the watermark and clears its
        markers — the journaled record was consumed conceptually, and
        leaving the markers set would wedge the drain forever — then the
        error propagates to whichever applier happened to pop it."""
        ran = 0
        with self._apply_lock:
            while True:
                try:
                    seq, fn, marks = self._deferred.popleft()
                except IndexError:
                    return ran
                try:
                    fn()
                finally:
                    self.note_backend_applied(seq)
                    self.mark_applied(marks)
                    self.stats_deferred_applies += 1
                    ran += 1

    # ---------------------------------------------------------- drain gate
    def has_unapplied(self) -> bool:
        """Cheap pre-check for the drain: almost always False, so batches
        skip the per-entry scan entirely."""
        return bool(self._unapplied)

    def meta_blocked(self, sid: int, idx: int) -> bool:
        """True while the entry's backend effect has not been applied —
        the drain must not consume past it."""
        with self._ua_lock:
            return (sid, idx) in self._unapplied

    def note_consumed(self, sid: int, start: int, count: int) -> None:
        """The drain durably retired ``[start, start+count)`` of shard
        ``sid``: drop any namespace records in that range and wake
        :meth:`wait_consumed` waiters."""
        with self._consumed:
            if not self._live:
                return
            dead = [m for m in self._live
                    if m[0] == sid and start <= m[1] < start + count]
            if dead:
                self._live.difference_update(dead)
                self._consumed.notify_all()

    def wait_consumed(self, timeout: Optional[float] = None) -> bool:
        """Block until every journaled record has been retired from the
        log — the namespace half of the ``flush()`` barrier (a File's
        ``pending`` counter covers only data entries)."""
        with self._consumed:
            return self._consumed.wait_for(lambda: not self._live,
                                           timeout=timeout)

    # ------------------------------------------------------------ fd slots
    def alloc_fdid_locked(self) -> int:
        """Caller holds :attr:`lock`."""
        if not self.fdid_free:
            raise OSError("fd table full")
        return self.fdid_free.pop()

    def free_fdid_locked(self, fdid: int) -> None:
        """Caller holds :attr:`lock`; the fdid's entries must be drained."""
        self.fdid_free.append(fdid)

    def bind_locked(self, path: str, f: object) -> None:
        """Caller holds :attr:`lock`."""
        self.files[path] = f
        self.by_fdid[f.fdid] = f

    def unbind_locked(self, f: object) -> None:
        """Caller holds :attr:`lock`."""
        self.files.pop(f.path, None)
        self.by_fdid.pop(f.fdid, None)

    def lookup(self, path: str) -> Optional[object]:
        return self.files.get(path)

    def resolve(self, fdid: int) -> Optional[object]:
        return self.by_fdid.get(fdid)
