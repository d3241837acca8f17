"""NVCache POSIX-like facade (paper §II-A, §III, Table III).

``NVCache`` is the interception boundary: components open files and call
``read/write/pread/pwrite/lseek/stat/fsync/close`` exactly as they would
against libc, and transparently get

  * synchronous durability — ``write`` returns only once the data is
    committed in the NVMM log (paper Alg. 1),
  * durable linearizability — a write is visible to a reader only when it
    is durable (the psync before the per-page lock release),
  * asynchronous propagation to the slow tier via the per-shard drain pool
    and its page-coalescing plan/apply engine (:mod:`repro.core.drain`),
  * ``fsync`` as a no-op (Table III: writes are already durable),
  * user-space file size/cursor (the kernel's may be stale, §II-C),
  * durable namespace ops — ``rename``/``unlink``/``ftruncate`` (and the
    implicit create in ``open``) journaled as metadata log entries so the
    crash-consistency protocols of legacy apps (SQLite journal unlink,
    RocksDB MANIFEST rename) survive power loss; see
    :mod:`repro.core.namespace`.

One instance == one NVMM region (one "DAX file"); several instances can
coexist on separate regions (paper §III Multi-application).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from repro_torch.core import locking
from repro_torch.core.cleanup import CleanupPool
from repro_torch.core.log import (META_NO_FDID, MOP_CREATE, MOP_FTRUNCATE,
                            MOP_RENAME, MOP_UNLINK, NVLog)
from repro_torch.core.namespace import Namespace
from repro_torch.core.nvmm import NVMM
from repro_torch.core.pager import PagedRegion
from repro_torch.core.policy import Policy, StreamClassifier
from repro_torch.core.readcache import AtomicInt, LRUCache, RadixTree
from repro_torch.core.router import EpochRouter
from repro_torch.core import recovery as _recovery
# submodule-object imports only: pulling a NAME out of repro.obs here
# would deadlock the repro.obs -> repro.core.locking -> repro.core ->
# api import cycle (ObsPlane is imported lazily in NVCache.__init__)
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics

O_RDONLY, O_WRONLY, O_RDWR = os.O_RDONLY, os.O_WRONLY, os.O_RDWR
O_CREAT, O_APPEND, O_TRUNC = os.O_CREAT, os.O_APPEND, os.O_TRUNC
_ACCMODE = os.O_ACCMODE


class File:
    """Per-(device,inode) state (paper §III "Open": the file table)."""

    __slots__ = ("path", "fdid", "backend", "radix", "size", "size_lock",
                 "refs", "pending", "shards_touched", "_drained", "ra_next",
                 "ra_window", "hwm", "_route_cv", "route_inflight",
                 "route_frozen", "unlinked", "pmode", "clf", "frames",
                 "skip_drain_fsync", "__weakref__")

    GUARDED_BY = {
        # route-epoch gate: every touch is inside `with self._route_cv`
        "route_inflight": "_route_cv", "route_frozen": "_route_cv",
        # logical length and committed high-water mark
        "size": "size_lock", "hwm": "size_lock",
        # readahead stream detector: racy by design (a heuristic, like the
        # kernel's per-file ra window — a lost update costs one prefetch)
        "ra_next": locking.VOLATILE, "ra_window": locking.VOLATILE,
        # refcount writes happen under NVCache._meta (another object's
        # lock, not expressible here); the drain thread's lock-free
        # `refs == 0` read is an opportunistic reap hint only — the
        # authoritative check re-runs in _maybe_retire_locked under _meta
        "refs": locking.VOLATILE,
        # monotonic flags set under _meta / the truncate journal window,
        # read lock-free on hot paths (stale False = one extra fsync)
        "unlinked": locking.VOLATILE, "skip_drain_fsync": locking.VOLATILE,
        # flips only inside a route_freeze window (writers excluded), so a
        # lock-free read sees a value stable for the write it gates
        "pmode": locking.VOLATILE,
        # published once at first write-open, before any write reaches us
        "clf": locking.VOLATILE,
        # never rebound; entries mutated under the owning page's
        # atomic_lock — a per-page guard is not one attribute
        "frames": locking.VOLATILE,
        # GIL-atomic set.add from writers; drain targeting reads via set()
        "shards_touched": locking.VOLATILE,
    }

    def __init__(self, path: str, fdid: int, backend):
        self.path = path
        self.fdid = fdid
        self.backend = backend
        self.radix: Optional[RadixTree] = None   # created on first write-open
        self.size = backend.size()
        self.hwm = self.size      # committed high-water mark: size minus any
        #                           not-yet-committed O_APPEND reservation
        self.size_lock = locking.make_lock("leaf:size")
        self.refs = 0
        self.pending = AtomicInt(0)              # log entries not yet drained
        self.shards_touched: set = set()         # sids holding entries for us
        self._drained = locking.make_condition("leaf:drained")
        self.ra_next = -1                        # readahead stream detector:
        #   the page a sequential miss stream would miss next; racy by
        #   design (a heuristic, like the kernel's per-file ra window)
        self.ra_window = 1                       # current ramped window size
        #   (grows 2->4->... toward Policy.readahead_pages on a sustained
        #    sequential miss stream, resets on a random miss)
        self.unlinked = False                    # POSIX unlink-while-open:
        #   the name is gone but the file lives until its last close; its
        #   drain skips the backend fsync (the bytes die with the name on
        #   any crash) and close() skips the drain barrier
        # dual persistence (VERSION 4): which mode this file's write stream
        # is in, the per-stream classifier (None without a paged region),
        # and the page_no -> frame index map of its NVMM-resident frames
        # (mutated under the page's atomic_lock)
        self.pmode = False                       # True == paged mode
        self.clf: Optional[StreamClassifier] = None
        self.frames: Dict[int, int] = {}
        self.skip_drain_fsync = False            # ftruncate(0) WAL-reset
        #   window: the barrier's drain skips the backend fsync for bytes
        #   the journaled truncate will discard anyway
        # route-epoch gate (adaptive routing only): writers enter before the
        # route lookup and exit after the log append, so a migration can
        # freeze the file and know no in-flight write still holds a stale
        # route (see core/router.py's ordering proof)
        self._route_cv = locking.make_condition("route_gate")
        self.route_inflight = 0
        self.route_frozen = False

    def note_drained(self, n: int) -> None:      # called by the cleanup thread
        self.pending.dec(n)
        with self._drained:
            self._drained.notify_all()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        with self._drained:
            return self._drained.wait_for(lambda: self.pending.get() <= 0,
                                          timeout=timeout)

    # ------------------------------------------------- route-epoch gate
    def route_enter(self) -> None:
        """Writer side: pin the routing epoch for one write (blocks while a
        migration of this file is in progress)."""
        with self._route_cv:
            while self.route_frozen:
                self._route_cv.wait()
            self.route_inflight += 1

    def route_exit(self) -> None:
        with self._route_cv:
            self.route_inflight -= 1
            if self.route_inflight == 0 and self.route_frozen:
                self._route_cv.notify_all()

    def route_freeze(self, timeout: Optional[float] = None) -> bool:
        """Migration side: block new writes and wait until in-flight writes
        (which looked up their shard under the old epoch) have committed.
        Returns False (and unfreezes) on timeout."""
        with self._route_cv:
            if self.route_frozen:
                return False                     # one migration at a time
            self.route_frozen = True
            if self._route_cv.wait_for(lambda: self.route_inflight == 0,
                                       timeout=timeout):
                return True
            self.route_frozen = False
            self._route_cv.notify_all()
            return False

    def route_unfreeze(self) -> None:
        with self._route_cv:
            self.route_frozen = False
            self._route_cv.notify_all()


class OpenFile:
    """Per-descriptor state (paper §III: the opened table / cursor)."""

    __slots__ = ("file", "flags", "cursor", "cursor_lock", "__weakref__")

    GUARDED_BY = {"cursor": "cursor_lock"}

    def __init__(self, file: File, flags: int):
        self.file = file
        self.flags = flags
        self.cursor = 0
        self.cursor_lock = locking.make_lock("leaf:cursor")


class NVCache:
    GUARDED_BY = {
        # the observability plane (registry + profiler + flight recorder):
        # published in __init__ before any engine thread starts and never
        # rebound; the metric objects inside synchronize themselves
        # (per-thread cells merged under leaf:obs, flight under leaf:flight)
        "obs": locking.VOLATILE,
    }

    def __init__(self, policy: Policy, tier, *, nvmm: Optional[NVMM] = None,
                 track_crashes: bool = False, recover: bool = True):
        self.policy = policy
        self.tier = tier
        self.nvmm = nvmm or NVMM(policy.nvmm_bytes, track=track_crashes)
        if recover and nvmm is not None:
            try:
                self.recovery_stats = _recovery.recover(self.nvmm, policy, tier)
            except ValueError:
                self.recovery_stats = None     # fresh region
                NVLog(self.nvmm, policy, format=True)
            self.log = NVLog(self.nvmm, policy, format=False)
        else:
            self.recovery_stats = None
            self.log = NVLog(self.nvmm, policy, format=True)

        # observability plane (PR 10): metrics registry + span profiler +
        # persistent flight recorder.  Built before any engine thread starts
        # so publication is ordered by thread creation (happens-before).
        from repro_torch.obs import ObsPlane
        self.obs = ObsPlane(policy, self.nvmm)
        for _sh in self.log.shards:
            _sh.obs = self.obs

        self.lru = LRUCache(policy.read_cache_pages, policy.page_size)
        # the durable namespace owns the file tables (path→File, fdid→File,
        # free fdid slots) and the metadata journaling protocol; the aliases
        # below are the same mutable objects, kept under the historic names
        self.ns = Namespace(self.log, tier, policy.fd_max)
        self._files: Dict[str, File] = self.ns.files
        self._by_fdid: Dict[int, File] = self.ns.by_fdid
        self._open: Dict[int, OpenFile] = {}
        self._next_fd = 3
        self._meta = self.ns.lock
        self._fdid_free = self.ns.fdid_free
        # adaptive shard routing (beyond paper, see core/router.py): the
        # router is created AFTER the log so it adopts the persisted route
        # record of an attached region (and an empty one after a format)
        self.router: Optional[EpochRouter] = None
        if policy.shard_rebalance:
            self.router = EpochRouter(self.nvmm, policy)
            self.log.router = self.router
        # dual persistence (VERSION 4): the paged region absorbing large /
        # overwrite-heavy streams in place (see core/pager.py)
        self.pager: Optional[PagedRegion] = None
        if policy.page_frames:
            self.pager = PagedRegion(self.nvmm, policy, self.log.next_seq)
        self.cleanup = CleanupPool(self.log, self._resolve_fdid,
                                   router=self.router,
                                   migrate=self._migrate_route
                                   if self.router is not None else None,
                                   meta_gate=self.ns,
                                   reap=self._reap_file,
                                   pager=self.pager,
                                   writeback=self._writeback_pressure,
                                   obs=self.obs)
        # engine counters live in the registry; the stats_* properties
        # below keep the historic read API
        reg = self.obs.registry
        self._c_mode_migrations = reg.counter("engine.mode_migration_total")
        self._c_dirty_misses = reg.counter("read.dirty_miss_total")
        self._c_replay_entries = reg.counter("read.replay_entry_total")
        self._c_ra_loads = reg.counter("read.readahead_load_total")
        self._c_ra_pages = reg.counter("read.readahead_page_total")
        self._c_ra_hits = reg.counter("read.readahead_hit_total")
        self._register_metrics()
        self.cleanup.start()
        self._crashed = False
        if self.obs.flight is not None:
            self.obs.flight.record(obs_flight.EV_ATTACH, self.obs.level,
                                   policy.shards, policy.flight_records)

    def _register_metrics(self) -> None:
        """Bind every legacy subsystem counter into the registry so
        ``stats()`` (and the ``--profile`` report) read one coherent
        snapshot.  Bound groups keep each subsystem's own locked
        ``snapshot_stats`` as the coherence unit."""
        reg = self.obs.registry
        reg.bind("engine.shard_count", lambda: self.policy.shards)
        reg.bind("log.used_count", lambda: self.log.used_entries)
        reg.bind("log.full_scan_total", lambda: self.log.stats_full_scans)
        reg.bind_summary(
            "log.alloc_wait_us",
            lambda: obs_metrics.Histogram.merged_snapshot(
                "log.alloc_wait_us",
                [sh.alloc_wait for sh in self.log.shards]))
        reg.bind_group({"lru.hit_total": "hits",
                        "lru.miss_total": "misses",
                        "lru.eviction_total": "evictions"},
                       self.lru.snapshot_stats)
        reg.bind_group({"nvmm.psync_total": "psync",
                        "nvmm.pwb_total": "pwb",
                        "nvmm.pwb_line_total": "pwb_lines",
                        "nvmm.fence_total": "fence",
                        "nvmm.stored_bytes": "stored"},
                       lambda: {"psync": self.nvmm.stats_psync,
                                "pwb": self.nvmm.stats_pwb,
                                "pwb_lines": self.nvmm.stats_pwb_lines,
                                "fence": self.nvmm.stats_fence,
                                "stored": self.nvmm.stats_stored_bytes})
        reg.bind_group({"drain.batch_total": "batches",
                        "drain.entry_total": "entries",
                        "drain.fsync_total": "fsyncs",
                        "drain.fsync_issued_total": "fsyncs_issued",
                        "drain.fsync_merged_total": "fsyncs_merged",
                        "drain.extent_total": "extents",
                        "drain.pwritev_total": "pwritevs",
                        "drain.deferred_total": "deferred",
                        "drain.span_merge_total": "span_merges"},
                       lambda: {"batches": self.cleanup.stats_batches,
                                "entries": self.cleanup.stats_entries,
                                "fsyncs": self.cleanup.stats_fsyncs,
                                "fsyncs_issued":
                                    self.cleanup.stats_fsyncs_issued,
                                "fsyncs_merged":
                                    self.cleanup.stats_fsyncs_merged,
                                "extents": self.cleanup.stats_extents,
                                "pwritevs": self.cleanup.stats_pwritevs,
                                "deferred": self.cleanup.stats_deferred,
                                "span_merges":
                                    self.cleanup.stats_span_merges})
        reg.bind_group({"route.epoch_count": "epoch",
                        "route.override_count": "overrides",
                        "route.skew_ratio": "skew_ratio",
                        "route.skipped_uneconomic_total":
                            "skipped_uneconomic",
                        "route.stripe_widening_total": "stripe_widenings"},
                       lambda: (self.router.snapshot_stats()
                                if self.router else {}))
        reg.bind("route.migration_total",
                 lambda: (self.cleanup.rebalancer.stats_migrations
                          if self.cleanup.rebalancer else 0))
        reg.bind_group({"meta.op_total": "meta_ops",
                        "meta.entry_total": "meta_entries",
                        "meta.deferred_apply_total": "deferred_applies"},
                       self.ns.snapshot_stats)
        reg.bind_group({"page.frame_used_count": "frames_used",
                        "page.frame_write_total": "frame_writes",
                        "page.frame_bytes": "frame_bytes",
                        "page.cow_bytes": "cow_bytes",
                        "page.writeback_total": "writebacks",
                        "page.alloc_fallback_total": "alloc_fail"},
                       lambda: (self.pager.snapshot_stats()
                                if self.pager else {}))

    # legacy read API for the registry-backed engine counters
    @property
    def stats_mode_migrations(self) -> int:
        return self._c_mode_migrations.value

    @property
    def stats_dirty_misses(self) -> int:
        return self._c_dirty_misses.value

    @property
    def stats_replay_entries(self) -> int:
        return self._c_replay_entries.value

    @property
    def stats_readahead_loads(self) -> int:
        return self._c_ra_loads.value

    @property
    def stats_readahead_pages(self) -> int:
        return self._c_ra_pages.value

    @property
    def stats_readahead_hits(self) -> int:
        return self._c_ra_hits.value

    def _flight_meta(self, op: int, fdid: int, mseq: int) -> None:
        """Record a journaled namespace op in the flight ring (rare event:
        recorded whenever the ring exists, regardless of obs_level)."""
        fl = self.obs.flight
        if fl is not None:
            fl.record(obs_flight.EV_META_OP, op,
                      0 if fdid is None else fdid, mseq)

    # ------------------------------------------------------------- lifecycle
    def _resolve_fdid(self, fdid: int) -> Optional[File]:
        return self._by_fdid.get(fdid)

    def _reap_file(self, f: File) -> None:
        """Drain-thread callback: an anonymous (unlinked) file's entries
        all landed.  Try-lock only — a drain thread must never wait on
        ``_meta`` (a writer holding it may itself be blocked on log space
        that only this drain can free); a missed reap is reclaimed by the
        ``flush()`` sweep or the fdid-exhaustion sweep in ``open()``."""
        if not self._meta.acquire(blocking=False):
            return
        try:
            self._maybe_retire_locked(f)
        finally:
            self._meta.release()

    def check(self) -> None:
        if self.cleanup.error is not None:
            raise RuntimeError("cleanup thread died") from self.cleanup.error
        if self._crashed:
            raise RuntimeError("instance crashed")

    def shutdown(self) -> None:
        """Graceful: drain the log, write back dirty frames, stop the
        cleanup threads."""
        if self.pager is not None:
            for f in list(self._by_fdid.values()):
                if not f.unlinked:
                    self._writeback_file_frames(f, free=False, do_fsync=True)
        self.cleanup.shutdown()
        self.check()

    def crash(self, choose_evicted=None) -> NVMM:
        """Simulated power loss; returns the NVMM region for recovery."""
        self._crashed = True
        self.cleanup.power_loss()
        if self.nvmm.track:
            self.nvmm.crash(choose_evicted)
        return self.nvmm

    def flush(self, timeout: Optional[float] = 60.0) -> None:
        """Drain the whole log to the slow tier (used as a barrier)."""
        self.cleanup.request_drain()
        try:
            # _by_fdid covers every bound File, including anonymous
            # (unlinked-while-open) ones that left the path table
            for f in list(self._by_fdid.values()):
                if not f.wait_drained(timeout=timeout):
                    raise TimeoutError(f"drain of {f.path} timed out")
            # namespace records are not any File's pending entries: wait
            # for them separately so "flush == the log is drained" holds
            if not self.ns.wait_consumed(timeout=timeout):
                raise TimeoutError("drain of namespace records timed out")
        finally:
            self.cleanup.end_drain()
        if self.pager is not None:
            # the paged half of the barrier: dirty frames reach the backend
            # (frames stay mapped — they are a valid NVMM-resident cache)
            for f in list(self._by_fdid.values()):
                if not f.unlinked:
                    self._writeback_file_frames(f, free=False, do_fsync=True)
        with self._meta:
            # sweep files orphaned by a timed-out close barrier or an
            # unlink-while-open (refs 0, kept only so the drain could
            # finish): they are drained now
            for f in list(self._by_fdid.values()):
                if f.refs == 0:
                    self._maybe_retire_locked(f)
        self.check()

    # ------------------------------------------------------------------ open
    def open(self, path: str, flags: int = O_RDWR | O_CREAT) -> int:
        self.check()
        accmode = flags & _ACCMODE
        with self._meta:
            # a queued rename apply may still be in flight: the backend
            # namespace must be current before exists()/open() consult it
            self.ns.apply_deferred()
            f = self.ns.lookup(path)
            if f is None:
                created = not self.tier.exists(path)
                if created and not flags & O_CREAT:
                    raise FileNotFoundError(path)
                if not self._fdid_free:
                    # reclaim drained anonymous/orphaned files whose reap
                    # lost the _meta try-lock race before giving up
                    for g in list(self._by_fdid.values()):
                        if g.refs == 0:
                            self._maybe_retire_locked(g)
                fdid = self.ns.alloc_fdid_locked()
                marks = None
                try:
                    self.log.fd_table_set(fdid, path)   # durable path for recovery
                    if created:
                        # journal the create BEFORE the backend file exists
                        # (WAL rule): a crash after this point re-creates
                        # the path from the log even if the kernel lost the
                        # directory update
                        marks, mseq = self.ns.journal_locked(MOP_CREATE, fdid, 0,
                                                      path)
                        self._flight_meta(MOP_CREATE, fdid, mseq)
                    backend = self.tier.open(path)
                    if created:
                        self.ns.note_backend_applied(mseq)
                except BaseException:
                    self.ns.free_fdid_locked(fdid)             # nothing references it
                    raise
                finally:
                    if marks is not None:
                        self.ns.mark_applied(marks)
                f = File(path, fdid, backend)
                if self.pager is not None:
                    f.clf = StreamClassifier(self.policy)
                self.ns.bind_locked(path, f)
            if accmode != O_RDONLY and f.radix is None:
                f.radix = RadixTree()               # read cache only for writers
            f.refs += 1
            fd = self._next_fd
            self._next_fd += 1
            of = OpenFile(f, flags)
            self._open[fd] = of
        if flags & O_TRUNC and accmode != O_RDONLY:
            try:
                self._truncate_file(f)
            except BaseException:
                # the caller gets an exception, not the fd — unwind the
                # registration above or the descriptor would leak forever
                with self._meta:
                    self._open.pop(fd, None)
                    self._release_file_locked(f)
                raise
        return fd

    def _release_file_locked(self, f: File) -> None:
        """Drop one reference; fully retire the file table entry once it is
        unreferenced AND drained.  Caller holds ``_meta``.

        The pending check is load-bearing: retiring the fdid while
        committed entries still point at it would make the drain drop them
        as orphans — or, worse, a reused fdid would route them into an
        unrelated file.  On a drain-barrier timeout the File therefore
        stays registered (and resolvable) until its entries land; it is
        reclaimed by a later open() of the same path (which adopts it) or
        by the orphan sweep in :meth:`flush`."""
        f.refs -= 1
        self._maybe_retire_locked(f)

    def _maybe_retire_locked(self, f: File) -> None:
        if f.refs != 0 or f.pending.get() > 0:
            return
        if self.pager is not None and f.frames:
            if f.unlinked:
                # the bytes die with the name: durably invalidate without
                # writeback, exactly like the fsync-free drain of unlinked
                # log entries.  Freeing BEFORE the fdid is reused below is
                # what stops a recovery from attributing the old frames to
                # the slot's next occupant.
                idxs = list(f.frames.values())
                f.frames.clear()
                self.pager.invalidate(idxs)
            else:
                # normally clean by now (close/flush wrote them back); a
                # timed-out barrier can leave dirty frames, so flush
                # defensively before the fdid slot is recycled
                self._writeback_file_frames(f, free=True, do_fsync=True)
        if f.unlinked:
            # anonymous (name already removed at unlink time): only the
            # fdid binding remains, kept so the drain could resolve it
            if self._by_fdid.get(f.fdid) is not f:
                return
            self._by_fdid.pop(f.fdid, None)
        else:
            if self._files.get(f.path) is not f:
                return
            self._files.pop(f.path, None)
            self._by_fdid.pop(f.fdid, None)
        self.log.fd_table_set(f.fdid, "")   # retire the NVMM slot
        if self.router is not None:
            # the file is drained (pending <= 0), so its overrides can
            # revert to static without stranding entries; keeping them
            # would leak table slots and mis-route a reused fdid
            self.router.drop_fdid(f.fdid)
        self._fdid_free.append(f.fdid)
        f.backend.close()

    def _truncate_file(self, f: File, length: int = 0) -> None:
        """Set the file's length *everywhere*, not just the backend
        (``O_TRUNC`` is ``length == 0``; ``ftruncate`` passes any length).

        Undrained log entries, dirty-page-index refs and loaded page
        contents all hold pre-truncate bytes; truncating only the backend
        let a later drain resurrect them and let cached reads serve stale
        data.  Order: drain the file's touched shards first (consuming its
        entries durably, exactly as ``close`` does — so a crash after this
        point cannot replay pre-truncate bytes either), journal the new
        length as a metadata log entry (the durable intent recovery
        replays, seq-ordered after every covered data entry), then purge
        the radix refs/contents beyond the new length under the page
        locks, then truncate the backend and the user-space size."""
        with f.size_lock:
            cur = f.size
        if cur == length and f.backend.size() == length:
            return                            # nothing to cut or extend
        # ftruncate(0) — the SQLite WAL reset — drains fsync-free: freeze
        # the route gate (no new commits; in-flight writes finish), journal
        # the truncate FIRST, and only then run the barrier with the
        # per-file fsync skip set.  Safe for the same reason the unlinked
        # drain is: every drained entry's seq is below the committed
        # truncate record's, so after any crash recovery either replays
        # entries-then-truncate or just the truncate — either way the
        # discarded bytes never needed to reach the device.  A gate that
        # cannot freeze (concurrent migration) falls back to the plain
        # ordering below.
        wal_reset = (length == 0 and not f.unlinked
                     and f.route_freeze(timeout=60.0))
        marks = None
        try:
            if wal_reset:
                with self._meta:
                    if f.unlinked:            # raced an unlink: plain path
                        pass
                    else:
                        marks, mseq = self.ns.journal_locked(MOP_FTRUNCATE, f.fdid,
                                                      0, f.path)
                        self._flight_meta(MOP_FTRUNCATE, f.fdid, mseq)
                f.skip_drain_fsync = True
                try:
                    self._drain_barrier(f, "ftruncate")
                finally:
                    f.skip_drain_fsync = False
            if marks is None:
                self._drain_barrier(f, "ftruncate")
                # journal under _meta like every namespace op (the Namespace
                # lock invariant): otherwise a concurrent unlink-while-open
                # could slip between the f.unlinked check and the journal
                # append, and recovery would replay the MOP_FTRUNCATE
                # *after* the unlink — re-creating the dead path as a
                # length-L file
                with self._meta:
                    if f.unlinked:
                        # anonymous file: no name to journal under (and none
                        # needed — the file is gone after any crash)
                        marks = None
                    else:
                        marks, mseq = self.ns.journal_locked(MOP_FTRUNCATE, f.fdid,
                                                      length, f.path)
                        self._flight_meta(MOP_FTRUNCATE, f.fdid, mseq)
            self._truncate_apply(f, length, marks, mseq if marks else 0)
        finally:
            if wal_reset:
                f.route_unfreeze()

    def _truncate_apply(self, f: File, length: int, marks, mseq: int) -> None:
        try:
            # order matters: size first (readers clamp against it, so no
            # new read can reach the cut bytes), then truncate the backend,
            # then purge — a reader that re-cached a pre-truncate page
            # between the drain and here is cleaned up by the purge.  A
            # load whose desc the purge walk could miss (inserted only
            # while the walk runs) is necessarily harmless: its backend
            # pread happens after the truncate below and reads zeros, while
            # any load that read the backend *before* the truncate inserted
            # its desc before the walk began and is purged under its locks.
            with f.size_lock:
                f.size = length
                f.hwm = min(f.hwm, length)
            f.backend.truncate(length)
            if f.radix is not None:
                ps = self.policy.page_size
                first_cut = -(-length // ps)      # first wholly-cut page
                cut_frames = []
                for d in f.radix.iter_descs():
                    if d.page_no < first_cut - 1:
                        continue                  # untouched by the cut
                    with d.atomic_lock, d.cleanup_lock:
                        fidx = f.frames.get(d.page_no)
                        if d.page_no >= first_cut:
                            if fidx is not None:
                                # wholly-cut frame: drop without writeback —
                                # the journaled truncate (higher seq) cuts
                                # it on replay too, so old-or-new holds
                                del f.frames[d.page_no]
                                cut_frames.append(fidx)
                            if d.content is not None:
                                d.content.desc = None  # LRU frees it
                                d.content = None
                                d.prefetched = False
                        elif length % ps:
                            if fidx is not None:
                                # boundary frame survives shorter: reseal
                                # its header so reads/recovery clamp to the
                                # new length (tail reads as zeros)
                                self.pager.truncate_frame(fidx, length % ps)
                            if d.content is not None:
                                # boundary page survives: zero its cut tail
                                # so a later size-growing write reads zeros
                                d.content.data[length % ps:] = \
                                    bytes(ps - length % ps)
                        # refs are NOT cleared here: the drain barrier above
                        # already retired every pre-truncate ref, so any ref
                        # present now belongs to a write committed *after*
                        # the barrier by a concurrent fd — clearing it would
                        # blind readers to an entry the drain will still land
                if cut_frames:
                    self.pager.invalidate(cut_frames)
            if marks is not None:
                self.ns.note_backend_applied(mseq)
        finally:
            if marks is not None:
                self.ns.mark_applied(marks)

    def _drain_barrier(self, f: File, label: str,
                       timeout: float = 60.0) -> None:
        """Drain the shards ``f`` touched and wait for its entries to land
        — the shared barrier under close/flock/O_TRUNC/route migration."""
        touched = set(f.shards_touched)
        prof = self.obs.prof
        fl = self.obs.flight
        if fl is not None:
            fl.record(obs_flight.EV_BARRIER_ENTER, f.fdid, len(touched))
        t0 = time.perf_counter_ns() if prof.lv1 else 0
        self.cleanup.request_drain(touched)
        try:
            if not f.wait_drained(timeout=timeout):
                raise TimeoutError(f"drain of {f.path} timed out on {label}")
        finally:
            self.cleanup.end_drain(touched)
            if prof.lv1:
                prof.h_barrier.record_ns(time.perf_counter_ns() - t0)
            if fl is not None:
                fl.record(obs_flight.EV_BARRIER_EXIT, f.fdid)

    def _migrate_route(self, mig) -> bool:
        """Execute one planned route migration (called by the pool's
        rebalance thread): freeze the file's route gate, drain the file's
        entries out of its old shard, install the new epoch, unfreeze.
        The barrier is what keeps the overlap invariant true across the
        epoch change — see core/router.py for the ordering proof.  Returns
        False (table untouched) when the freeze or barrier cannot complete.
        """
        with self._meta:
            f = self._by_fdid.get(mig.fdid)
        if f is None:
            # file retired since the plan was made: the load data is stale
            # and the fdid may already be reused by a NEW file (whose gate
            # we never froze) — installing now would reroute that file
            # without the barrier.  Skip; the next epoch re-plans.
            return False
        if not f.route_freeze(timeout=10.0):
            return False
        try:
            self._drain_barrier(f, "rebalance", timeout=10.0)
            with self._meta:
                if self._by_fdid.get(mig.fdid) is not f:
                    return False    # retired (and possibly reused) mid-
                    #                 migration: same hazard as above
                if mig.new_shift is not None:
                    # stripe-width widening: re-route the whole file at a
                    # narrower stripe instead of moving one key — the
                    # barrier above makes the width change safe for the
                    # same reason a key move is (no undrained entry spans
                    # the old and new stripe maps)
                    ok = self.router.install_width(mig.fdid, mig.new_shift)
                else:
                    ok = self.router.install(mig.key, mig.new_sid)
                if ok and self.obs.flight is not None:
                    self.obs.flight.record(obs_flight.EV_ROUTE_EPOCH,
                                           mig.fdid, mig.new_sid,
                                           0 if mig.new_shift is None
                                           else mig.new_shift)
                return ok
        except TimeoutError:
            return False
        finally:
            f.route_unfreeze()

    # --------------------------------------------- dual-mode machinery
    def _migrate_mode(self, f: File, to_paged: bool,
                      timeout: float = 10.0) -> bool:
        """Move a live file between persistence modes behind the shared
        freeze/barrier protocol (the generalized ``_migrate_route``):
        freeze the route gate (no new writes commit; in-flight ones
        finish), drain the file's log entries, and — for page→log — write
        its frames back and free them.  After the flip every page of the
        file is cleanly owned by the new mode.  Returns False (no state
        changed) when the freeze or barrier cannot complete."""
        if self.pager is None or f.pmode == to_paged or f.unlinked:
            return False
        if not f.route_freeze(timeout=timeout):
            return False
        try:
            self._drain_barrier(f, "mode-migration", timeout=timeout)
            if not to_paged:
                # leaving paged mode: frames flush to the backend and are
                # freed so subsequent log-mode writes re-own the pages
                self._writeback_file_frames(f, free=True, do_fsync=True)
            f.pmode = to_paged
            self._c_mode_migrations.inc()
            if self.obs.flight is not None:
                self.obs.flight.record(obs_flight.EV_MODE_MIGRATE, f.fdid,
                                       1 if to_paged else 0)
            return True
        except TimeoutError:
            return False
        finally:
            f.route_unfreeze()

    def _writeback_file_frames(self, f: File, idxs=None, *, free: bool,
                               do_fsync: bool) -> int:
        """Flush (a subset of) a file's frames to the backend — the paged
        twin of the drain's apply step, minus replay: the frame already IS
        the coalesced page image.  ``free`` additionally unmaps and
        durably invalidates the written frames (page→log migration,
        retirement); it always pairs with ``do_fsync=True`` — freeing a
        frame whose bytes only reached the device cache would open a
        data-loss window no log entry ever has."""
        if self.pager is None or not f.frames:
            return 0
        ps = self.policy.page_size
        items = sorted((pn, ix) for pn, ix in f.frames.items()
                       if idxs is None or ix in idxs)
        wrote = []
        for page_no, idx in items:
            d = f.radix.get_or_create(page_no)
            with d.atomic_lock:
                if f.frames.get(page_no) != idx:
                    continue                  # raced a truncate/retire
                view, ln = self.pager.read(idx)
                if ln:
                    f.backend.pwrite(bytes(view), page_no * ps)
                if free:
                    del f.frames[page_no]
                wrote.append(idx)
        if wrote and do_fsync and not f.unlinked:
            f.backend.fsync()
        for idx in wrote:
            self.pager.mark_clean(idx)
        if free and wrote:
            self.pager.invalidate(wrote)
        return len(wrote)

    def _writeback_pressure(self, max_frames: int = 32) -> int:
        """Pool-pressure callback (the pager's writeback thread): flush the
        oldest-dirty frames so allocation keeps finding clean capacity,
        mirroring the drain's role for the log half."""
        if self.pager is None:
            return 0
        total = 0
        for fdid, idxs in self.pager.dirty_victims(max_frames).items():
            f = self._by_fdid.get(fdid)
            if f is None:
                continue
            total += self._writeback_file_frames(f, idxs, free=False,
                                                 do_fsync=True)
        return total

    def close(self, fd: int) -> None:
        """Flush this file's pending writes to the kernel, then close
        (paper §I: coherence across processes via flush-on-close).  Only the
        shards this file actually touched are asked to drain."""
        of = self._pop_fd(fd)
        f = of.file
        try:
            if not f.unlinked:
                # an unlinked (anonymous) file dies with its last close:
                # nothing to make coherent for other processes, so no
                # barrier — its remaining entries drain (fsync-free) in
                # the background and the reap retires the fdid
                self._drain_barrier(f, "close")
                if self.pager is not None and f.frames:
                    # the paged half of flush-on-close: frames reach the
                    # kernel too (they stay mapped as cache — the last
                    # close retires them via _maybe_retire_locked)
                    self._writeback_file_frames(f, free=False, do_fsync=True)
        finally:
            # teardown must run even when the drain barrier fails: the fd
            # was already popped, so skipping the refcount would leak the
            # File, its fdid slot and its NVMM fd-table entry forever.
            # (_release_file_locked keeps the File resolvable while
            # undrained entries exist — a timed-out barrier must not turn
            # acknowledged bytes into orphans.)
            with self._meta:
                self._release_file_locked(f)
        self.check()

    def _pop_fd(self, fd: int) -> OpenFile:
        with self._meta:
            of = self._open.pop(fd, None)
        if of is None:
            raise OSError(f"bad fd {fd}")
        return of

    def _of(self, fd: int) -> OpenFile:
        of = self._open.get(fd)
        if of is None:
            raise OSError(f"bad fd {fd}")
        return of

    # ----------------------------------------------------------------- write
    def pwrite(self, fd: int, data: bytes, off: int) -> int:
        of = self._of(fd)
        if of.flags & _ACCMODE == O_RDONLY:
            raise OSError("fd is read-only")
        if off < 0:
            raise OSError("negative offset (EINVAL)")
        if not data:
            return 0
        return self._pwrite_split(of.file, data, off)

    def _pwrite_split(self, f: File, data: bytes, off: int,
                      progress: Optional[list] = None) -> int:
        """Split a write into per-op chunks and commit each (Alg. 1).

        ``progress``, when given, is a 1-element list updated with the
        bytes durably committed so far — after a mid-write failure those
        bytes are in the log (and will reach the backend / survive
        recovery), so callers that roll back bookkeeping must roll back to
        ``off + progress[0]``, never to ``off``."""
        pol = self.policy
        max_op = (pol.entries_per_shard - 1) * pol.entry_data
        split_stripes = pol.shards > 1 and pol.shard_route == "stripe"
        # stream classification (dual persistence): feed the write to the
        # per-file classifier BEFORE entering the route gate — a proposed
        # mode switch runs the migration protocol, which freezes that very
        # gate.  confirm() only after the migration actually lands, so a
        # failed freeze (concurrent migration) re-proposes on later writes.
        if f.clf is not None and not f.unlinked:
            switch = f.clf.note_write(off, len(data))
            if switch is not None and self._migrate_mode(f, switch == "page"):
                f.clf.confirm(switch)
        # the whole split runs under the file's route gate, so every
        # chunk's route lookup sees ONE routing epoch and a migration
        # cannot slip between lookup and log append (the stale-route race
        # core/router.py rules out); mode migration and the ftruncate(0)
        # WAL-reset freeze reuse the same gate, so it is held in every
        # configuration, not just under adaptive routing
        f.route_enter()
        prof = self.obs.prof
        lv1 = prof.lv1
        try:
            written = 0
            view = memoryview(data)
            while written < len(data):
                lim = max_op
                if split_stripes:
                    # ops never span a stripe: overlapping writes always
                    # route to the same shard, keeping per-location order a
                    # shard-local property (see core/log.py docstring)
                    sb = self._stripe_bytes_of(f)
                    lim = min(lim, sb - (off + written) % sb)
                chunk = view[written:written + lim]
                t0 = time.perf_counter_ns() if lv1 else 0
                self._pwrite_op(f, bytes(chunk), off + written)
                if lv1:
                    prof.h_op.record_ns(time.perf_counter_ns() - t0)
                written += len(chunk)
                if progress is not None:
                    progress[0] = written
        finally:
            f.route_exit()
        return len(data)

    def _stripe_bytes_of(self, f: File) -> int:
        """Effective stripe width for this file — narrowed by the router's
        per-fdid width tuning when the file is persistently hot."""
        if self.router is not None:
            return self.router.stripe_bytes_of(f.fdid)
        return self.policy.stripe_bytes

    def _pwrite_op(self, f: File, data: bytes, off: int) -> None:
        """One atomic write op == one committed entry group (Alg. 1)."""
        if f.pmode and self.pager is not None:
            return self._pwrite_paged(f, data, off)
        ps = self.policy.page_size
        n = len(data)
        p0, p1 = off // ps, (off + max(n, 1) - 1) // ps
        descs = [f.radix.get_or_create(p) for p in range(p0, p1 + 1)]

        def register(sid: int, head: int, k: int, seq: int) -> None:
            # runs between log allocation and commit: the refs are in the
            # dirty-page index before the drain can possibly see (and try
            # to retire) the entries.  shard membership likewise becomes
            # visible before the pending count below can, so a concurrent
            # close() that sees pending > 0 also sees the shard id.
            f.shards_touched.add(sid)
            for ref in self.log.group_refs(sid, head, k, seq, off, n):
                r1 = (ref.off + max(ref.length, 1) - 1) // ps
                for p in range(ref.off // ps, r1 + 1):
                    descs[p - p0].add_ref(ref)

        for d in descs:                       # ascending page order: no deadlock
            d.atomic_lock.acquire()
        try:
            sid, head, k, seq = self.log.append(f.fdid, off, data,
                                                on_alloc=register)  # durable
            f.pending.inc(k)
            # update loaded pages so reads stay fresh (Alg. 1 lines 29-31)
            for d in descs:
                if d.content is not None:
                    pstart = d.page_no * ps
                    s = max(off, pstart)
                    e = min(off + n, pstart + ps)
                    if s < e:
                        d.content.data[s - pstart:e - pstart] = data[s - off:e - off]
                d.accessed = True
            with f.size_lock:
                if off + n > f.size:
                    f.size = off + n
                if off + n > f.hwm:
                    f.hwm = off + n
        finally:
            for d in reversed(descs):
                d.atomic_lock.release()

    # ------------------------------------------------- paged write path
    def _pwrite_paged(self, f: File, data: bytes, off: int) -> None:
        """One write op in paged mode: each touched page lands in its NVMM
        frame **in place** (the ping-pong slot flip in core/pager.py is the
        commit point) instead of appending a log entry — the whole point of
        the mode: N overwrites of a page cost N page-stores, not N log
        entries that each drain to the backend.

        Per-page old-or-new (same guarantee the log gives per op group):
        each page's flip is atomic, pages commit in ascending order under
        their atomic locks.  A page that cannot get a frame — pool
        exhausted, or the page still has undrained log refs (mode just
        flipped and the barrier raced a concurrent fd) — falls back to a
        per-page log append, preserving the ownership invariant: a (file,
        page) is either framed or logged, never both."""
        ps = self.policy.page_size
        n = len(data)
        p0, p1 = off // ps, (off + max(n, 1) - 1) // ps
        descs = [f.radix.get_or_create(p) for p in range(p0, p1 + 1)]
        for d in descs:                       # ascending page order: no deadlock
            d.atomic_lock.acquire()
        try:
            for d in descs:
                pstart = d.page_no * ps
                s = max(off, pstart)
                e = min(off + n, pstart + ps)
                chunk = memoryview(data)[s - off:e - off]
                idx = f.frames.get(d.page_no)
                if idx is None and not d.dirty_refs:
                    # materialize only once the page has no live log refs:
                    # a frame's image must already contain every committed
                    # byte of the page, or recovery (which replays the
                    # frame at its seq) would resurrect pre-ref state
                    idx = self.pager.alloc(f.fdid, d.page_no)
                    if idx is not None:
                        f.frames[d.page_no] = idx
                        base, valid = self._page_base_image(f, d, pstart)
                        self.pager.frame_write(idx, f.fdid, d.page_no,
                                               s - pstart, e - pstart,
                                               chunk, base, valid)
                elif idx is not None:
                    self.pager.frame_write(idx, f.fdid, d.page_no,
                                           s - pstart, e - pstart,
                                           chunk, None, 0)
                if idx is None:
                    # per-page log fallback (pool exhausted / refs present)
                    self._append_page_chunk(f, d, bytes(chunk), s)
                if d.content is not None:
                    d.content.data[s - pstart:e - pstart] = chunk
                d.accessed = True
            with f.size_lock:
                if off + n > f.size:
                    f.size = off + n
                if off + n > f.hwm:
                    f.hwm = off + n
        finally:
            for d in reversed(descs):
                d.atomic_lock.release()

    def _page_base_image(self, f: File, d, pstart: int) -> tuple:
        """Committed bytes of page ``d`` for frame materialization, as
        ``(image, valid_len)``.  Caller holds ``d.atomic_lock`` and has
        checked ``not d.dirty_refs`` — so a cached content IS the committed
        state, and absent that the backend is (every log entry for the
        page has drained)."""
        ps = self.policy.page_size
        with f.size_lock:
            valid = max(0, min(ps, f.size - pstart))
        if valid == 0:
            return None, 0
        if d.content is not None:
            return bytes(d.content.data[:valid]), valid
        raw = f.backend.pread(valid, pstart)
        if len(raw) < valid:
            raw = raw + bytes(valid - len(raw))
        return raw, valid

    def _append_page_chunk(self, f: File, d, chunk: bytes, abs_s: int) -> None:
        """Log fallback for ONE page of a paged-mode write: a normal
        committed entry group confined to ``d`` (the caller already holds
        ``d.atomic_lock``)."""
        def register(sid: int, head: int, k: int, seq: int) -> None:
            f.shards_touched.add(sid)
            for ref in self.log.group_refs(sid, head, k, seq, abs_s,
                                           len(chunk)):
                d.add_ref(ref)

        _sid, _head, k, _seq = self.log.append(f.fdid, abs_s, chunk,
                                               on_alloc=register)
        f.pending.inc(k)

    def write(self, fd: int, data: bytes) -> int:
        of = self._of(fd)
        f = of.file
        with of.cursor_lock:
            if of.flags & O_APPEND:
                # reserve the range up front so concurrent appends get
                # disjoint offsets; roll the reservation back if the log
                # append fails (LogFullTimeout), else the size stays
                # inflated forever and readers see zero-filled bytes that
                # were never written.  A split write that fails midway
                # rolls back only to the committed prefix — those bytes
                # are durable in the log and recovery WILL land them, so
                # hiding them behind a smaller size would resurrect them
                # as "stale bytes past EOF" after a crash.
                if of.flags & _ACCMODE == O_RDONLY:
                    raise OSError("fd is read-only")
                with f.size_lock:
                    off = f.size
                    f.size = off + len(data)
                progress = [0]
                try:
                    n = (self._pwrite_split(f, data, off, progress)
                         if data else 0)
                except BaseException:
                    with f.size_lock:
                        if f.size == off + len(data):   # no append raced past
                            # never shrink below the committed high-water
                            # mark: a concurrent pwrite INTO our reserved
                            # range leaves size untouched but its bytes
                            # are durable — hiding them behind a smaller
                            # size would lose acknowledged data
                            f.size = max(off + progress[0], f.hwm)
                    raise
            else:
                off = of.cursor
                n = self.pwrite(fd, data, off)
            of.cursor = off + n
            return n

    # ------------------------------------------------------------------ read
    def pread(self, fd: int, n: int, off: int) -> bytes:
        of = self._of(fd)
        if off < 0:
            raise OSError("negative offset (EINVAL)")
        f = of.file
        with f.size_lock:
            size = f.size
        if off >= size:
            return b""
        n = min(n, size - off)
        if f.radix is None:
            # read-only file: bypass the read cache entirely (§II-A) — the
            # kernel page cache is fresh because nothing is in flight.
            out = f.backend.pread(n, off)
            return out + b"\x00" * (n - len(out))
        return self._pread_cached(f, n, off)

    def _pread_cached(self, f: File, n: int, off: int) -> bytes:
        ps = self.policy.page_size
        out = bytearray(n)
        pos = off
        just_loaded = -1
        while pos < off + n:
            p = pos // ps
            d = f.radix.get_or_create(p)
            with d.atomic_lock:
                c = d.content
                if c is not None:
                    if p != just_loaded:      # the retry after our own
                        self.lru.note_hit()        # miss load is not a hit
                        if d.prefetched:      # first demand-hit on a
                            d.prefetched = False   # readahead-loaded page
                            self._c_ra_hits.inc()
                    d.accessed = True
                    pstart = p * ps
                    s = pos - pstart
                    e = min(off + n - pstart, ps)
                    out[pos - off:pstart + e - off] = c.data[s:e]
                    pos = pstart + e
                    continue
            # miss: load the aligned extent covering p (takes its own
            # locks), then retry this page — it can in principle be evicted
            # again before the retry, in which case the loop reloads it
            prof = self.obs.prof
            if prof.lv2:
                t0 = time.perf_counter_ns()
                self._load_extent(f, p)
                prof.h_read_load.record_ns(time.perf_counter_ns() - t0)
            else:
                self._load_extent(f, p)
            just_loaded = p
        return bytes(out)

    def _extent_range(self, f: File, p: int) -> tuple:
        """Readahead window [e0, e1) around page ``p``: up to
        ``Policy.readahead_pages`` pages (clamped to half the read cache so
        a load can never flush the cache it feeds), clipped to the file's
        last page.

        Readahead opens only for a *sequential* miss stream (``p`` is the
        page the previous miss predicted, kernel-style): a random miss
        loads just its own page, so random workloads never pay device cost
        for 7 prefetched pages they will evict unused.

        With ``Policy.readahead_ramp`` (the default) the window *ramps*
        like the kernel's: the first sequential miss after a reset loads 2
        pages, then 4, then 8 ... up to the cap, and any random miss
        resets the ramp — a short sequential burst pays for 2-4 pages
        instead of the full window it would never use.  ``ramp=False``
        keeps the PR-3 behavior: the full aligned window on the first
        sequential miss."""
        cap = min(self.policy.readahead_pages, max(1, self.lru.capacity // 2))
        if cap <= 1 or p != f.ra_next:
            f.ra_next = p + 1
            f.ra_window = 1                   # random miss: reset the ramp
            return p, p + 1
        with f.size_lock:
            size = f.size
        last = (size - 1) // self.policy.page_size if size > 0 else 0
        if self.policy.readahead_ramp:
            w = min(cap, max(2, 2 * f.ra_window))
            f.ra_window = w
            e0, e1 = p, max(p + 1, min(p + w, last + 1))
        else:
            e0 = (p // cap) * cap
            e1 = max(p + 1, min(e0 + cap, last + 1))
        f.ra_next = e1
        return e0, e1

    def _load_extent(self, f: File, p: int) -> None:
        """Cache-miss path, extent-granular (the read-side twin of the
        drain engine; paper Fig. 2 generalized from one page to one aligned
        extent): acquire buffers, one vectored backend read for the
        extent's uncached runs, then the per-page dirty-index replay —
        readahead NEVER bypasses the replay, so prefetched pages obey the
        same durable-linearizability rules as demand misses."""
        ps = self.policy.page_size
        e0, e1 = self._extent_range(f, p)
        descs = [f.radix.get_or_create(q) for q in range(e0, e1)]
        held = descs
        for d in descs:                       # ascending: same order writers use
            d.atomic_lock.acquire()
        try:
            need = [d for d in descs if d.content is None]
            if not any(d.page_no == p for d in need):
                return                        # raced: another reader loaded p
            # drop the locks of in-window pages that are already cached:
            # nothing below touches them, and holding them would stall
            # writers to those pages for a device-read latency
            needset = {id(d) for d in need}
            for d in descs:
                if id(d) not in needset:
                    d.atomic_lock.release()
            held = need
            self.lru.note_miss()
            if len(need) > 1:
                self._c_ra_loads.inc()
                self._c_ra_pages.inc(len(need) - 1)
            bufs = self.lru.acquire_buffers(len(need))
            for d in need:                    # ascending, after atomic locks
                d.cleanup_lock.acquire()
            try:
                # NVMM-framed pages (paged mode) are served straight from
                # their frame — the frame IS the committed page image, so
                # they cost no device read and no replay; only the rest
                # goes to the backend
                frames = f.frames if self.pager is not None else {}
                fetch = [d for d in need if d.page_no not in frames]
                raw_by_page = {}
                if fetch:
                    # one backend operation: contiguous runs of missing
                    # pages become the iovec segments (pages loaded/cached
                    # in between are skipped, not re-read)
                    iov = []
                    run_start = prev = None
                    for d in fetch:
                        if prev is not None and d.page_no == prev + 1:
                            prev = d.page_no
                            continue
                        if run_start is not None:
                            iov.append(((prev - run_start + 1) * ps,
                                        run_start * ps))
                        run_start = prev = d.page_no
                    iov.append(((prev - run_start + 1) * ps, run_start * ps))
                    preadv = getattr(f.backend, "preadv", None)
                    if preadv is not None:
                        chunks = preadv(iov)
                    else:
                        chunks = [f.backend.pread(nn, oo) for nn, oo in iov]
                    for (nn, oo), chunk in zip(iov, chunks):
                        for q in range(oo // ps, (oo + nn) // ps):
                            raw_by_page[q] = chunk[q * ps - oo:(q + 1) * ps - oo]
                for d, content in zip(need, bufs):
                    fidx = frames.get(d.page_no)
                    if fidx is not None:
                        view, ln = self.pager.read(fidx)
                        content.data[:ln] = view
                        if ln < ps:
                            content.data[ln:] = bytes(ps - ln)
                        # no replay: a framed page has no live log refs
                        # (the ownership invariant — see _pwrite_paged)
                    else:
                        raw = raw_by_page[d.page_no]
                        content.data[:len(raw)] = raw
                        if len(raw) < ps:
                            content.data[len(raw):] = bytes(ps - len(raw))
                        self._replay_page(d, content)
                    self.lru.attach(d, content)
                    d.prefetched = d.page_no != p
            finally:
                for d in reversed(need):
                    d.cleanup_lock.release()
        finally:
            for d in reversed(held):
                d.atomic_lock.release()

    def _replay_page(self, d, content) -> None:
        """Dirty-miss replay under the page's cleanup lock: apply ONLY this
        page's live entries from the dirty-page index, already in commit
        (seq) order — O(E) for E entries on the page, where the
        dirty-counter design had to rescan the whole log.  All of a page's
        entries live in one shard (overlap routing), and holding
        cleanup_lock means none of them can be retired/recycled mid-replay,
        so ref_payload reads are stable."""
        refs = d.snapshot_refs()
        if not refs:
            return
        ps = self.policy.page_size
        base = d.page_no * ps
        self._c_dirty_misses.inc()
        self._c_replay_entries.inc(len(refs))
        prof = self.obs.prof
        t0 = time.perf_counter_ns() if prof.lv2 else 0
        for ref in refs:
            edata = self.log.ref_payload(ref)
            s = max(ref.off, base)
            t = min(ref.off + ref.length, base + ps)
            if s < t:
                content.data[s - base:t - base] = edata[s - ref.off:t - ref.off]
        if prof.lv2:
            prof.h_read_replay.record_ns(time.perf_counter_ns() - t0)

    def read(self, fd: int, n: int) -> bytes:
        of = self._of(fd)
        with of.cursor_lock:
            out = self.pread(fd, n, of.cursor)
            of.cursor += len(out)
            return out

    # ----------------------------------------------------- metadata (§II-C)
    def fsync(self, fd: int) -> None:
        """No-op: writes are already synchronously durable (Table III)."""
        self._of(fd)

    # -- durable namespace ops (core/namespace.py): each quiesces the
    #    touched file(s) behind the drain barrier, journals the op as a
    #    committed NVMM log entry, then applies the backend effect — so an
    #    acknowledged rename/unlink/ftruncate survives any crash, and
    #    recovery's seq-merge replays it old-or-new, never torn.
    def _lookup_closed_locked(self, path: str) -> Optional[File]:
        """The File at ``path`` verified to have no open descriptors
        (namespace ops refuse open files — the legacy protocols we model
        close before rename/unlink).  Caller holds ``_meta``."""
        f = self._files.get(path)
        if f is not None and f.refs > 0:
            raise OSError(f"{path} is open (EBUSY)")
        return f

    def unlink(self, path: str) -> None:
        """Remove ``path`` (the SQLite rollback-journal commit point).

        The journal record commits BEFORE the backend unlink, so a crash
        at any point leaves the file either present (op not acknowledged)
        or durably gone — its bytes can never resurrect: recovery replays
        the unlink at a seq above every covered data entry.

        POSIX unlink-while-open: with live descriptors the *name* is
        removed now and the file turns anonymous — reads/writes through
        open fds keep working, the file is reclaimed at its last close,
        and after a crash it is simply gone (its post-unlink writes are
        dropped as orphans: the fd-table slot is cleared with the name).
        This is what lets SQLite delete a hot journal without first paying
        a close barrier, and what makes the journal's drain skip the
        backend fsync entirely (see ``File.unlinked``)."""
        self.check()
        with self._meta:
            self.ns.apply_deferred()   # backend must be current for exists()
            f = self._files.get(path)
            if f is None and not self.tier.exists(path):
                raise FileNotFoundError(path)
            marks, mseq = self.ns.journal_locked(
                MOP_UNLINK, f.fdid if f is not None else META_NO_FDID,
                0, path)
            self._flight_meta(MOP_UNLINK,
                              f.fdid if f is not None else META_NO_FDID,
                              mseq)
            try:
                if f is not None:
                    f.unlinked = True
                    self._files.pop(path, None)    # fdid stays bound
                    # undrained and post-unlink entries die with a crash
                    # (POSIX): clearing the slot makes recovery drop them
                    # as orphans instead of re-creating the dead name —
                    # the unlink record above outranks them all by seq
                    self.log.fd_table_set(f.fdid, "")
                self.tier.unlink(path)
                self.ns.note_backend_applied(mseq)
                if f is not None:
                    # closed and already drained: reclaim on the spot;
                    # otherwise the drain's reap (or the flush sweep)
                    # retires it once its entries are consumed
                    self._maybe_retire_locked(f)
            finally:
                self.ns.mark_applied(marks)
        self.check()

    def rename(self, old: str, new: str) -> None:
        """Atomically move ``old`` over ``new`` (the RocksDB MANIFEST
        install).  Both paths must have no open descriptors; an existing
        ``new`` is replaced, and after recovery the data is attributed to
        exactly one of the two names — never both, never neither."""
        self.check()
        if old == new:
            with self._meta:
                self.ns.apply_deferred()
                if (self._files.get(old) is None
                        and not self.tier.exists(old)):
                    raise FileNotFoundError(old)
            return
        deadline = time.monotonic() + 120.0
        while True:
            with self._meta:
                self.ns.apply_deferred()   # prior renames must be visible
                fo = self._lookup_closed_locked(old)
                fn = self._lookup_closed_locked(new)
                if fo is None and not self.tier.exists(old):
                    raise FileNotFoundError(old)
                stale = fo if (fo is not None and fo.pending.get() > 0) \
                    else (fn if (fn is not None and fn.pending.get() > 0)
                          else None)
                if stale is None:
                    marks, mseq = self.ns.journal_locked(
                        MOP_RENAME,
                        fo.fdid if fo is not None else META_NO_FDID, 0,
                        old, new)
                    self._flight_meta(
                        MOP_RENAME,
                        fo.fdid if fo is not None else META_NO_FDID, mseq)
                    if fo is not None:
                        self._maybe_retire_locked(fo)
                    if fn is not None:
                        self._maybe_retire_locked(fn)
                    # deferred backend apply (core/namespace.py): the
                    # slow-tier directory update leaves the _meta critical
                    # section — queued here, run just below without the
                    # lock (or by a drain thread if we lose the race)
                    self.ns.queue_apply(
                        mseq,
                        lambda o=old, n=new: self.tier.rename(o, n),
                        marks)
                    break
            self._drain_barrier(stale, "rename")
            if time.monotonic() > deadline:
                raise TimeoutError(f"rename {old} -> {new} could not quiesce")
        # run the queued apply ourselves, outside _meta: the call returns
        # with the backend current, but racing namespace ops no longer
        # serialize behind the directory update
        self.ns.apply_deferred()
        self.check()

    def ftruncate(self, fd: int, length: int) -> None:
        """Set the open file's length (SQLite WAL reset).  Journaled like
        rename/unlink; shrinking purges cached/dirty state beyond the new
        length so cut bytes never resurrect, growing zero-fills."""
        of = self._of(fd)
        if of.flags & _ACCMODE == O_RDONLY:
            raise OSError("fd is read-only")
        if length < 0:
            raise OSError("negative length (EINVAL)")
        self._truncate_file(of.file, length)
        self.check()

    def flock(self, fd: int, unlock: bool = False) -> None:
        """Advisory lock hook (paper §I): releasing a lock flushes this
        file's pending writes to the kernel so other processes see them."""
        of = self._of(fd)
        if unlock:
            self._drain_barrier(of.file, "flock release")

    def lseek(self, fd: int, off: int, whence: int = os.SEEK_SET) -> int:
        of = self._of(fd)
        with of.cursor_lock:
            if whence == os.SEEK_SET:
                target = off
            elif whence == os.SEEK_CUR:
                target = of.cursor + off
            elif whence == os.SEEK_END:
                with of.file.size_lock:
                    target = of.file.size + off
            else:
                raise OSError("bad whence")
            if target < 0:
                raise OSError("negative seek (EINVAL)")  # cursor unchanged
            of.cursor = target
            return of.cursor

    def stat_size(self, fd_or_path) -> int:
        if isinstance(fd_or_path, int):
            f = self._of(fd_or_path).file
        else:
            f = self._files.get(fd_or_path)
            if f is None:
                self.ns.apply_deferred()   # queued renames affect existence
                # stat must not mutate the namespace: Tier.open inserts on
                # miss, which used to create an empty phantom file here
                size_of = getattr(self.tier, "size_of", None)
                if size_of is not None:
                    return size_of(fd_or_path)   # raises FileNotFoundError
                if not self.tier.exists(fd_or_path):
                    raise FileNotFoundError(fd_or_path)
                return self.tier.open(fd_or_path).size()
        with f.size_lock:
            return f.size

    # ------------------------------------------------------------- stats
    def metrics(self) -> dict:
        """The registry snapshot under canonical ``subsystem.noun_unit``
        names — counters, bound legacy stats and latency-histogram
        summaries in one dict (see ``src/repro/obs/README.md``)."""
        return self.obs.registry.snapshot()

    def profile_report(self) -> str:
        """Human-readable per-stage latency table (``--profile``).
        Empty-ish at ``obs_level=0`` — spans are not recorded."""
        return self.obs.prof.report()

    def stats(self) -> dict:
        """Aggregate counters under the historic flat key names.

        One registry snapshot backs the whole dict: each subsystem's
        legacy counters are bound into the registry as a group whose
        callback still reads under that subsystem's own lock
        (``snapshot_stats``), so no key exposes a torn or mid-update
        view.  New callers should prefer :meth:`metrics`, which returns
        the same snapshot under canonical names."""
        m = self.obs.registry.snapshot()
        aw = m["log.alloc_wait_us"]
        ra_pages = m["read.readahead_page_total"]
        ra_hits = m["read.readahead_hit_total"]
        return {
            "shards": m["engine.shard_count"],
            "log_used": m["log.used_count"],
            "dirty_misses": m["read.dirty_miss_total"],
            "replay_entries": m["read.replay_entry_total"],
            "log_full_scans": m["log.full_scan_total"],
            "lru_hits": m["lru.hit_total"],
            "lru_misses": m["lru.miss_total"],
            "lru_evictions": m["lru.eviction_total"],
            "readahead_loads": m["read.readahead_load_total"],
            "readahead_pages": ra_pages,
            "readahead_hits": ra_hits,
            "readahead_hit_rate": ra_hits / max(1, ra_pages),
            "cleanup_batches": m["drain.batch_total"],
            "cleanup_entries": m["drain.entry_total"],
            "cleanup_fsyncs": m["drain.fsync_total"],
            "cleanup_fsyncs_issued": m["drain.fsync_issued_total"],
            "cleanup_fsyncs_merged": m["drain.fsync_merged_total"],
            "drain_extents": m["drain.extent_total"],
            "drain_pwritevs": m["drain.pwritev_total"],
            "drain_deferred": m["drain.deferred_total"],
            "drain_span_merges": m["drain.span_merge_total"],
            "nvmm_psyncs": m["nvmm.psync_total"],
            "nvmm_pwbs": m["nvmm.pwb_total"],
            "nvmm_pwb_lines": m["nvmm.pwb_line_total"],
            "nvmm_fences": m["nvmm.fence_total"],
            "nvmm_stored_bytes": m["nvmm.stored_bytes"],
            # alloc-wait is a real distribution now (PR 10): the flat
            # seconds sum stays for old readers, count/mean/p95 added so
            # a zero-count window can't masquerade as a measured average
            "alloc_wait_s": aw["sum_us"] * 1e-6,
            "alloc_waits": aw["count"],
            "alloc_wait_mean_us": aw["mean_us"],
            "alloc_wait_p95_us": aw["p95_us"],
            "route_epoch": m["route.epoch_count"],
            "route_overrides": m["route.override_count"],
            "route_migrations": m["route.migration_total"],
            "route_skew_ratio": m["route.skew_ratio"],
            "route_skipped_uneconomic":
                m["route.skipped_uneconomic_total"],
            "route_stripe_widenings": m["route.stripe_widening_total"],
            "meta_ops": m["meta.op_total"],
            "meta_entries": m["meta.entry_total"],
            "meta_deferred_applies": m["meta.deferred_apply_total"],
            "mode_migrations": m["engine.mode_migration_total"],
            "paged_frames_used": m["page.frame_used_count"],
            "paged_frame_writes": m["page.frame_write_total"],
            "paged_frame_bytes": m["page.frame_bytes"],
            "paged_cow_bytes": m["page.cow_bytes"],
            "paged_writebacks": m["page.writeback_total"],
            "paged_alloc_fallbacks": m["page.alloc_fallback_total"],
        }
