"""The drain pool (paper §II-A step 6, §III "Cleanup thread and batching"),
one drain thread per log shard, draining through the page-coalescing
plan/apply engine of :mod:`repro.core.drain`.

Each :class:`CleanupThread` consumes committed entries in log order from its
shard's persistent tail.  Where the paper forwards them to the slow tier one
``pwrite`` per entry and relies on the kernel page cache to write-combine
(§IV-C), we build an explicit :class:`~repro.core.drain.DrainPlan` — entries
grouped by (file, page), merged into page images, coalesced into extents —
and apply it with vectored writes, so each dirty backend page is written at
most once per batch.  Then one fsync per touched file per batch, routed
through the pool's cross-shard :class:`~repro.core.drain.FsyncEpochScheduler`
(concurrent per-shard fsyncs of the same backend file merge into one), and
only then is the batch durably retired (zero commit flags, advance the
shard's persistent tail, pwb/pfence, advance the volatile tail).  Because
any two overlapping writes are routed to the same shard (see
:mod:`repro.core.log`), independent per-shard drains cannot reorder
conflicting updates, and K shards drain to the slow tier concurrently.

Batching (paper §IV-C): each drainer waits for at least ``batch_min``
committed entries in its shard unless a drain is requested (close/flush/
log-full backpressure), and consumes at most ``batch_max`` — the shared
:class:`~repro.core.policy.Policy` bounds are the pool's common
backpressure contract.

Batch-*spanning* coalescing (beyond paper; cf. NVLog's open tail extent):
a batch may leave its contiguous tail extent — the still-filling tail page
— unconsumed (:func:`repro.core.drain.choose_deferred_suffix`), so the
next batch's contiguous entries merge into the same backend write instead
of re-writing the page per tiny batch.  The carry is closed by fresh
non-contiguous entries, by ``Policy.coalesce_deadline_ms``, by log-space
pressure, or by any drain barrier; carried entries remain committed in the
log with live dirty-page-index refs, so reads and recovery are untouched.

:class:`CleanupPool` owns the threads and lets callers target a drain at
just the shards a file actually touched (``fsync``/``close`` wait only on
those) or at every shard (``flush``).

With ``Policy.shard_rebalance`` the pool also owns the
:class:`RebalanceThread`: every ``Policy.rebalance_epoch_ms`` it samples
per-shard load (:meth:`repro.core.log.LogShard.load_sample` — live entries,
drain backlog, allocation-wait time) plus the router's per-key append
counters, asks :meth:`repro.core.router.EpochRouter.plan` for migrations,
and executes each through the owner's ``migrate`` callback
(:meth:`repro.core.api.NVCache._migrate_route`: freeze the file's route
gate, run the per-file drain barrier, install the new epoch).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

from repro_torch.core import drain as _drain
from repro_torch.core import locking
from repro_torch.core.drain import FsyncEpochScheduler
from repro_torch.core.log import CG_HEAD, META_FDID, LogShard, NVLog
from repro_torch.obs import flight as _obs_flight


class CleanupThread(threading.Thread):
    """Drains one shard (the paper's cleanup thread when K == 1)."""

    GUARDED_BY = {
        "_drain_count": "_drain_lock",
        # the span carry is drain-thread-confined: only run() touches it,
        # and start()/join() order everything else against it
        "_span_deferred": None, "_span_oldest": None, "_span_since": None,
        "_span_maxidx": None, "_span_carry_batches": None,
        # single-writer per-thread counters, folded at read by the pool's
        # summing properties; a live read (api.stats() mid-run) sees a
        # monotonic approximation by design, exact after join()
        "error": locking.VOLATILE,
        "stats_batches": locking.VOLATILE, "stats_entries": locking.VOLATILE,
        "stats_fsyncs": locking.VOLATILE, "stats_extents": locking.VOLATILE,
        "stats_pwritevs": locking.VOLATILE,
        "stats_deferred": locking.VOLATILE,
        "stats_span_merges": locking.VOLATILE,
        # observability plane handle: set once before start() (publication
        # ordered by thread creation), internally synchronized
        "obs": locking.VOLATILE,
    }

    def __init__(self, log: NVLog, shard: LogShard,
                 resolve_file: Callable[[int], Optional[object]],
                 *, fsync_scheduler: Optional[FsyncEpochScheduler] = None,
                 meta_gate=None, reap: Optional[Callable] = None,
                 name: Optional[str] = None, obs=None):
        super().__init__(name=name or f"nvcache-drain-{shard.sid}", daemon=True)
        self.log = log
        self.shard = shard
        self.obs = obs                        # guarded-by: volatile (set
        #   before start(); see GUARDED_BY)
        self.resolve_file = resolve_file      # fdid -> File (api.File) or None
        self.fsync_scheduler = fsync_scheduler
        self.meta_gate = meta_gate            # namespace (or None): blocks
        #   consumption of committed-but-not-yet-applied metadata entries
        self.reap = reap                      # owner callback to reclaim a
        #   fully-drained anonymous (unlinked) file; must never block
        self.drain_event = threading.Event()  # ignore batch_min
        self.stop_event = threading.Event()   # finish current batch, then exit
        self.hard_stop = threading.Event()    # simulated power loss: exit NOW
        self.fault_hook: Optional[Callable[[str], None]] = None
        # ^ test-only: called at every plan/apply checkpoint (tag), may set
        #   hard_stop to simulate power loss at that exact drain point
        self._drain_count = 0                 # guarded-by: _drain_lock
        self._drain_lock = locking.make_lock("leaf:drain_gate")
        # batch-spanning coalescing: the carried (deferred, unconsumed)
        # tail-extent entries of the previous batch, their oldest log index
        # (the identity of the open extent) and when they were first carried
        # guarded-by: none — drain-thread-confined (ordered by start/join)
        self._span_deferred = 0
        self._span_oldest = -1
        self._span_since = 0.0
        self._span_maxidx = -1                # highest log idx ever carried
        self._span_carry_batches = 0          # batches feeding the open carry
        # guarded-by: volatile — single-writer (this thread); folded at
        # read by CleanupPool's properties, exact after join()
        self.error: Optional[BaseException] = None
        self.stats_batches = 0
        self.stats_entries = 0
        self.stats_fsyncs = 0                 # fsyncs *requested* (pre-merge)
        self.stats_extents = 0                # extent writes issued
        self.stats_pwritevs = 0               # vectored write calls issued
        self.stats_deferred = 0               # entries carried across batches
        self.stats_span_merges = 0            # batches that merged a carry

    def run(self) -> None:
        obs = self.obs
        lv2 = obs is not None and obs.prof.lv2
        try:
            while not self.hard_stop.is_set():
                min_needed = 1 if self.drain_event.is_set() else self.log.policy.batch_min
                deadline_at = None
                if self._span_deferred:
                    deadline_at = (self._span_since +
                                   self.log.policy.coalesce_deadline_ms / 1e3)
                t0 = time.perf_counter_ns() if lv2 else 0
                run = self.shard.wait_committed(min_needed,
                                               drain_event=self.drain_event,
                                               stop_event=self.stop_event,
                                               deferred=self._span_deferred,
                                               deadline_at=deadline_at)
                if lv2:
                    obs.prof.h_drain_wait.record_ns(
                        time.perf_counter_ns() - t0)
                if run == 0:
                    if self.stop_event.is_set() or self.hard_stop.is_set():
                        return
                    continue
                self._consume_batch(run)
        except BaseException as exc:  # surfaces in api.check()
            self.error = exc

    # ------------------------------------------------------------------
    def _abort(self, tag: str) -> bool:
        """Plan/apply checkpoint: power loss mid-batch leaves the log
        unconsumed, so recovery replays the whole batch (idempotent)."""
        if self.fault_hook is not None:
            self.fault_hook(tag)
        return self.hard_stop.is_set()

    def _clip_unapplied(self, start: int, run: int) -> int:
        """Stop the batch short of the first committed metadata entry whose
        backend effect is not applied yet (the journal→apply window of
        :mod:`repro.core.namespace`): consuming it would let a crash lose a
        namespace op the log still owes the backend.  The window is
        microseconds wide, so the clipped remainder drains on the next
        round."""
        for e in self.shard.scan_committed(start, start + run):
            if (e.cg == CG_HEAD and e.fdid == META_FDID
                    and self.meta_gate.meta_blocked(self.shard.sid, e.idx)):
                return e.idx - start
        return run

    def _consume_batch(self, run: int) -> None:
        shard = self.shard
        pol = self.log.policy
        start = shard.persistent_tail
        if self.meta_gate is not None and self.meta_gate.has_unapplied():
            # the drain's meta-apply path: a queued deferred apply (rename)
            # must not depend on its originating thread for progress — run
            # the queue here before clipping, so the blocking record is
            # usually already applied by the time we scan for it
            apply_deferred = getattr(self.meta_gate, "apply_deferred", None)
            if apply_deferred is not None:
                apply_deferred()
        if self.meta_gate is not None and self.meta_gate.has_unapplied():
            run = self._clip_unapplied(start, run)
            if run == 0:                      # blocked at the very tail:
                time.sleep(1e-3)              # wait out the apply window
                return
        # phase 0: batch-spanning coalescing — leave the contiguous tail
        # extent unconsumed (its consume/ref-retire deferred until it is
        # flushed) so the next batch's contiguous entries merge into one
        # backend write.  Everything below operates on the shortened run;
        # the deferred entries simply stay committed at the log tail.
        carried = self._span_deferred
        defer = self._choose_defer(run)
        eff = run - defer
        if eff == 0:                          # whole batch stays open
            self._note_deferred(start, run)
            return
        obs = self.obs
        lv2 = obs is not None and obs.prof.lv2
        # phase 1: group by (file, page), materialize images, coalesce extents
        t0 = time.perf_counter_ns() if lv2 else 0
        plan = _drain.build_plan(shard, start, eff, self.resolve_file, pol,
                                 abort=self._abort)
        if lv2:
            obs.prof.h_drain_plan.record_ns(time.perf_counter_ns() - t0)
        if plan is None:
            return
        # phase 2: extent writes under page cleanup locks + index retire
        t0 = time.perf_counter_ns() if lv2 else 0
        drained = _drain.apply_plan(plan, pol, abort=self._abort, stats=self)
        if lv2:
            obs.prof.h_drain_apply.record_ns(time.perf_counter_ns() - t0)
        if drained is None:
            return
        if self._abort(_drain.FSYNC):
            return
        t0 = time.perf_counter_ns() if lv2 else 0
        for f in drained:
            if getattr(f, "unlinked", False):
                continue    # anonymous (unlinked-while-open) file: its
                #             bytes die with the name on any crash, so
                #             device durability buys nothing — this skip is
                #             what makes deleting a hot journal cheap
            if getattr(f, "skip_drain_fsync", False):
                continue    # ftruncate(0) WAL-reset window: the journaled
                #             truncate (already committed, higher seq) will
                #             discard these bytes on any crash — same
                #             reasoning as the unlinked skip, scoped to the
                #             barrier the truncate itself runs

            self.stats_fsyncs += 1            # one request per file per batch
            if self.fsync_scheduler is not None:
                self.fsync_scheduler.fsync(f.backend)
            else:
                f.backend.fsync()
        if lv2:
            obs.prof.h_drain_fsync.record_ns(time.perf_counter_ns() - t0)
        if self._abort(_drain.CONSUME):
            return
        shard.consume(start, eff)             # durably retire the batch
        if obs is not None and obs.flight is not None:
            obs.flight.record(_obs_flight.EV_BATCH, shard.sid, start, eff)
        if self.meta_gate is not None and plan.meta_entries:
            self.meta_gate.note_consumed(shard.sid, start, eff)
        if carried and (run > carried or self._span_carry_batches > 1):
            # a real cross-batch write-combine: the plan joined carried
            # entries with newer ones, or flushed a carry that accumulated
            # over several batches — a lone carry flushed by the deadline
            # with nothing to merge does not count
            self.stats_span_merges += 1
        for f, n in drained.items():
            f.note_drained(n)
            if (self.reap is not None and getattr(f, "unlinked", False)
                    and f.refs == 0 and f.pending.get() <= 0):
                # last entries of a dead anonymous file just landed: give
                # the owner a chance to reclaim its fdid without waiting
                # for the next flush() sweep
                self.reap(f)
        self.stats_entries += sum(drained.values())
        self.stats_batches += 1
        self._note_deferred(start + eff, defer)

    def _choose_defer(self, run: int) -> int:
        """Entries of this batch to carry (see
        :func:`repro.core.drain.choose_deferred_suffix`), or 0 when a
        barrier forbids carrying: an explicit drain request (close/flush/
        fsync must make everything durable on the slow tier), shutdown, an
        expired carry deadline, or log-space pressure (writers may be
        blocked on recycling — the carry must never extend a log-full
        stall)."""
        pol = self.log.policy
        if not (pol.drain_coalesce and pol.coalesce_span_batches):
            return 0
        if (self.drain_event.is_set() or self.stop_event.is_set()
                or self.hard_stop.is_set()):
            return 0
        if (self._span_deferred
                and time.monotonic() - self._span_since
                >= pol.coalesce_deadline_ms / 1e3):
            return 0
        if 2 * self.shard.used_entries >= self.shard.n:
            return 0
        return _drain.choose_deferred_suffix(
            self.shard, self.shard.persistent_tail, run, pol)

    def _note_deferred(self, dstart: int, count: int) -> None:
        if count <= 0:
            self._span_deferred = 0
            self._span_oldest = -1
            return
        if not (self._span_deferred and self._span_oldest == dstart):
            # a different open extent; same extent (possibly grown) keeps
            # its age from the FIRST carry, so the deadline bounds real age
            self._span_since = time.monotonic()
            self._span_oldest = dstart
            self._span_carry_batches = 1
        elif count > self._span_deferred:     # another batch joined the carry
            self._span_carry_batches += 1
        last = dstart + count - 1
        if last > self._span_maxidx:          # count each entry's carry once
            self.stats_deferred += last - max(self._span_maxidx, dstart - 1)
            self._span_maxidx = last
        self._span_deferred = count

    # ------------------------------------------------------------------
    def request_drain(self) -> None:
        with self._drain_lock:
            self._drain_count += 1
            self.drain_event.set()
        self.shard.notify_committed()

    def end_drain(self) -> None:
        with self._drain_lock:
            self._drain_count = max(0, self._drain_count - 1)
            if self._drain_count == 0:
                self.drain_event.clear()

    def shutdown(self) -> None:
        """Graceful: drain everything, then stop."""
        self.request_drain()
        self.stop_event.set()
        self.shard.notify_committed()
        self.join(timeout=60)

    def power_loss(self) -> None:
        """Simulated crash: the thread dies wherever it is."""
        self.hard_stop.set()
        self.stop_event.set()
        self.shard.notify_committed()
        self.join(timeout=60)


class RebalanceThread(threading.Thread):
    """The router's epoch clock: sample shard load, plan, migrate.

    Migrations run OUTSIDE the drain threads (a migration's drain barrier
    *waits on* them), so a slow barrier never stalls draining.  A migration
    that fails its barrier (timeout) is simply skipped — the route table is
    untouched and the next epoch retries with fresh load data.
    """

    GUARDED_BY = {
        "_last_wait": None,                  # rebalance-thread-confined
        # guarded-by: volatile — single-writer per-thread counters (see
        # CleanupThread); live stats() reads are approximate by design
        "error": locking.VOLATILE, "stats_ticks": locking.VOLATILE,
        "stats_migrations": locking.VOLATILE,
        "stats_failed_migrations": locking.VOLATILE,
    }

    def __init__(self, log: NVLog, router,
                 migrate: Callable[[object], bool]):
        super().__init__(name="nvcache-rebalance", daemon=True)
        self.log = log
        self.router = router
        self.migrate = migrate               # Migration -> installed?
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None  # guarded-by: volatile
        self._last_wait = [0.0] * len(log.shards)   # alloc-wait deltas
        self.stats_ticks = 0
        self.stats_migrations = 0
        self.stats_failed_migrations = 0

    def run(self) -> None:
        period = self.log.policy.rebalance_epoch_ms / 1e3
        try:
            while not self.stop_event.wait(period):
                self.tick()
        except BaseException as exc:         # surfaces in api.check()
            self.error = exc

    def tick(self) -> None:
        """One sampling epoch: visible separately so tests can step the
        rebalancer deterministically without the wall clock."""
        self.stats_ticks += 1
        samples = [sh.load_sample() for sh in self.log.shards]
        waits = [s["alloc_wait_s"] for s in samples]
        deltas = [w - p for w, p in zip(waits, self._last_wait)]
        self._last_wait = waits
        plan = self.router.plan([s["queue"] for s in samples],
                                wait_deltas=deltas)
        for mig in plan:
            if self.stop_event.is_set():
                return
            try:
                ok = self.migrate(mig)
            except TimeoutError:
                ok = False                   # barrier timed out: retry later
            if ok:
                self.stats_migrations += 1
            else:
                self.stats_failed_migrations += 1

    def shutdown(self) -> None:
        self.stop_event.set()
        if self.is_alive():
            self.join(timeout=60)


class PagerWritebackThread(threading.Thread):
    """The paged region's counterpart of the drain threads: flush the
    oldest dirty frames to the backend when the pool runs hot (over the
    dirty watermark, or an allocation found the free list short/empty and
    set the pressure event).  Writeback does NOT free frames — a clean
    frame is still a valid NVMM-resident cache; freeing happens on mode
    migration, truncate and retirement (:mod:`repro.core.api`)."""

    POLL_S = 0.01

    GUARDED_BY = {
        # guarded-by: volatile — single-writer per-thread counters (see
        # CleanupThread); live stats() reads are approximate by design
        "error": locking.VOLATILE, "stats_rounds": locking.VOLATILE,
    }

    def __init__(self, pager, writeback: Callable[[], int]):
        super().__init__(name="nvcache-pager-wb", daemon=True)
        self.pager = pager
        self.writeback = writeback           # owner cb: flush dirty victims
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None  # guarded-by: volatile
        self.stats_rounds = 0

    def run(self) -> None:
        try:
            while not self.stop_event.is_set():
                self.pager.pressure.wait(timeout=self.POLL_S)
                if self.stop_event.is_set():
                    return
                if not (self.pager.pressure.is_set()
                        or self.pager.over_watermark()):
                    continue
                self.pager.pressure.clear()
                self.stats_rounds += 1
                while (self.pager.over_watermark()
                       and not self.stop_event.is_set()):
                    if self.writeback() == 0:
                        break                # victims' files unresolvable
                self.writeback()             # one pass even below watermark
        except BaseException as exc:         # surfaces in api.check()
            self.error = exc

    def shutdown(self) -> None:
        self.stop_event.set()
        self.pager.pressure.set()            # wake the wait
        if self.is_alive():
            self.join(timeout=60)


class CleanupPool:
    """One drain thread per shard, addressed collectively or per shard.

    The pool owns the cross-shard :class:`FsyncEpochScheduler`: per-shard
    batches that finish around the same time and touch the same backend
    file share one fsync epoch instead of issuing K device fsyncs.  With
    adaptive routing it also owns the :class:`RebalanceThread`, and with a
    paged region the :class:`PagerWritebackThread`.
    """

    def __init__(self, log: NVLog,
                 resolve_file: Callable[[int], Optional[object]],
                 *, router=None, migrate: Optional[Callable] = None,
                 meta_gate=None, reap: Optional[Callable] = None,
                 pager=None, writeback: Optional[Callable] = None,
                 obs=None):
        self.log = log
        self.fsync_scheduler = FsyncEpochScheduler(
            enabled=log.policy.fsync_epoch)
        self.threads = [CleanupThread(log, sh, resolve_file,
                                      fsync_scheduler=self.fsync_scheduler,
                                      meta_gate=meta_gate, reap=reap,
                                      obs=obs)
                        for sh in log.shards]
        self.rebalancer: Optional[RebalanceThread] = None
        if router is not None and migrate is not None:
            self.rebalancer = RebalanceThread(log, router, migrate)
        self.pager_wb: Optional[PagerWritebackThread] = None
        if pager is not None and writeback is not None:
            self.pager_wb = PagerWritebackThread(pager, writeback)

    def start(self) -> None:
        for t in self.threads:
            t.start()
        if self.rebalancer is not None:
            self.rebalancer.start()
        if self.pager_wb is not None:
            self.pager_wb.start()

    def _targets(self, shards: Optional[Iterable[int]]):
        if shards is None:
            return self.threads
        return [self.threads[s] for s in sorted(set(shards))]

    def request_drain(self, shards: Optional[Iterable[int]] = None) -> None:
        for t in self._targets(shards):
            t.request_drain()

    def end_drain(self, shards: Optional[Iterable[int]] = None) -> None:
        for t in self._targets(shards):
            t.end_drain()

    def shutdown(self) -> None:
        # the rebalancer first: a migration mid-flight may hold drain
        # requests the threads below must still serve before stopping
        if self.rebalancer is not None:
            self.rebalancer.shutdown()
        if self.pager_wb is not None:
            self.pager_wb.shutdown()
        for t in self.threads:
            t.shutdown()

    def power_loss(self) -> None:
        if self.rebalancer is not None:
            self.rebalancer.stop_event.set()
        if self.pager_wb is not None:
            self.pager_wb.stop_event.set()
            self.pager_wb.pager.pressure.set()
        for t in self.threads:
            t.hard_stop.set()
            t.stop_event.set()
            t.shard.notify_committed()
        for t in self.threads:
            t.join(timeout=60)
        if self.rebalancer is not None and self.rebalancer.is_alive():
            self.rebalancer.join(timeout=60)
        if self.pager_wb is not None and self.pager_wb.is_alive():
            self.pager_wb.join(timeout=60)

    # ------------------------------------------------------------- status
    @property
    def error(self) -> Optional[BaseException]:
        for t in self.threads:
            if t.error is not None:
                return t.error
        if self.rebalancer is not None and self.rebalancer.error is not None:
            return self.rebalancer.error
        if self.pager_wb is not None:
            return self.pager_wb.error
        return None

    @property
    def stats_batches(self) -> int:
        return sum(t.stats_batches for t in self.threads)

    @property
    def stats_entries(self) -> int:
        return sum(t.stats_entries for t in self.threads)

    @property
    def stats_fsyncs(self) -> int:
        return sum(t.stats_fsyncs for t in self.threads)

    @property
    def stats_extents(self) -> int:
        return sum(t.stats_extents for t in self.threads)

    @property
    def stats_pwritevs(self) -> int:
        return sum(t.stats_pwritevs for t in self.threads)

    @property
    def stats_deferred(self) -> int:
        return sum(t.stats_deferred for t in self.threads)

    @property
    def stats_span_merges(self) -> int:
        return sum(t.stats_span_merges for t in self.threads)

    @property
    def stats_fsyncs_issued(self) -> int:
        return self.fsync_scheduler.stats_issued_snapshot

    @property
    def stats_fsyncs_merged(self) -> int:
        return self.fsync_scheduler.stats_merged
