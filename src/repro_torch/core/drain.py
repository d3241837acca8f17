"""Page-coalescing drain engine: a two-phase **plan/apply** propagation path.

The paper's cleanup thread (§II-A step 6) forwards log entries to the slow
tier one ``pwrite`` at a time and leans on the kernel page cache to
write-combine them before they hit the device (§IV-C: batching works
*because* the kernel merges the small writes).  This module makes that
write-combining explicit and moves it above the syscall boundary, the way
dm-writeboost submits one bio for hundreds of data+metadata blocks:

* **Phase 1 — plan** (:func:`build_plan`): walk the batch's committed
  entries in shard-log order and group them by (file, page).  Overlapping
  and adjacent entries are merged into *materialized page images* (the
  paper's "the kernel combines the writes", §IV-C, done eagerly in user
  space), and runs of contiguous pages are coalesced into *extents*, so
  each dirty backend page is written at most once per batch no matter how
  many small log entries touched it.
* **Phase 2 — apply** (:func:`apply_plan`): take the cleanup locks of the
  affected pages (the reader/cleanup exclusion of §II-D), issue the extents
  as vectored ``pwritev`` calls (one syscall per file per batch instead of
  one per entry), and retire each page's entry refs from the dirty-page
  index (:class:`~repro.core.readcache.PageDesc`) — the accounting that
  step 6 of §II-A does per entry, done per page here.

Durability ordering is unchanged from the paper: nothing in the log is
retired (:meth:`~repro.core.log.LogShard.consume`) until the extents are
written *and* fsynced, so a power loss at any plan/apply point replays the
whole batch from the log — extent writes are idempotent prefixes of that
replay.  Refs are retired only after the covering extent reached the
backend, so a dirty-miss read that interleaves with apply always finds
either the ref (and replays from NVMM) or the bytes (in the backend).

:class:`FsyncEpochScheduler` is the cross-shard half of the story
(§IV-C's one-fsync-per-batch, generalized to K drain threads): concurrent
per-shard fsyncs against the same backend file are merged into epochs —
callers that arrive while an fsync is in flight share the single next one.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core import locking
from repro_torch.core.log import CG_HEAD, META_FDID, LogShard
from repro_torch.core.policy import Policy

# fault-injection / power-loss checkpoint tags, in batch order
PLAN_ENTRY = "plan:entry"
APPLY_FILE = "apply:file"
APPLY_EXTENT = "apply:extent"
APPLY_RETIRE = "apply:retire"
FSYNC = "fsync"
CONSUME = "consume"

AbortFn = Callable[[str], bool]


class Extent:
    """One contiguous backend write: merged bytes plus, per covered page,
    the entry indices whose refs it retires once written."""

    __slots__ = ("off", "data", "pages", "retire")

    def __init__(self, off: int, data: bytearray,
                 pages: List[int], retire: Dict[int, List[int]]):
        self.off = off
        self.data = data
        self.pages = pages            # covered page numbers, ascending
        self.retire = retire          # page_no -> [entry idx] to retire

    def __len__(self) -> int:
        return len(self.data)


class FilePlan:
    __slots__ = ("file", "extents", "entries", "nbytes")

    def __init__(self, file):
        self.file = file
        self.extents: List[Extent] = []
        self.entries = 0              # log entries drained for this file
        self.nbytes = 0


class DrainPlan:
    """Phase-1 output: per-file extent lists for one batch of one shard."""

    __slots__ = ("sid", "start", "run", "files", "orphans", "meta_entries")

    def __init__(self, sid: int, start: int, run: int):
        self.sid = sid
        self.start = start
        self.run = run
        self.files: List[FilePlan] = []
        self.orphans = 0              # entries whose file is gone (dropped)
        self.meta_entries = 0         # namespace records in the batch (their
        #                               backend effect is already applied —
        #                               the caller's gate guarantees it — so
        #                               the drain only retires them)


class _PageImage:
    """A page being materialized: merged byte ranges + contributing entries."""

    __slots__ = ("buf", "ranges", "spans")

    def __init__(self, page_size: int):
        self.buf = bytearray(page_size)
        self.ranges: List[tuple] = []   # merged covered [s, e), page-relative
        self.spans: List[tuple] = []    # (idx, s, e) per contributing entry

    def add(self, s: int, e: int, data, idx: int) -> None:
        self.buf[s:e] = data
        self.spans.append((idx, s, e))
        ns, ne = s, e
        out = []
        for a, b in self.ranges:
            if b < ns or a > ne:        # disjoint and not adjacent
                out.append((a, b))
            else:                       # overlap or touch: absorb
                ns, ne = min(a, ns), max(b, ne)
        out.append((ns, ne))
        out.sort()
        self.ranges = out


class _FileAcc:
    __slots__ = ("file", "pages", "raw", "entries", "nbytes")

    def __init__(self, file):
        self.file = file
        self.pages: Dict[int, _PageImage] = {}
        self.raw: List[tuple] = []      # legacy mode: (off, bytes, idx)
        self.entries = 0
        self.nbytes = 0


def choose_deferred_suffix(shard: LogShard, start: int, run: int,
                           policy: Policy) -> int:
    """Batch-spanning coalescing, phase 0: how many log-order tail entries
    of this batch to leave *unconsumed* so the next batch's contiguous
    entries merge into the same backend write (the way NVLog keeps its tail
    extent open across syncs).

    The carried suffix is the maximal run of whole committed groups,
    walking back from the batch tail, that (a) belong to one file, (b)
    union into a single contiguous byte interval — the open tail extent —
    and (c) lie inside ONE page-aligned page: the open tail *page*.  The
    page boundary is the natural cut because a page whose bytes are all
    present can never be improved by further coalescing (it is written once
    either way), while the still-filling tail page is exactly what a small
    trailing batch would otherwise rewrite per batch; the one-page cap also
    keeps the carry negligible for big saturated batches (no latency
    hiccups).  Deferring is merely *not draining yet*: the entries stay
    committed in the log, their dirty-page-index refs stay live, reads
    replay them and recovery replays them — every durability invariant
    holds by construction, and the next batch's plan re-materializes them
    together with the new entries (write-combined across the batch
    boundary).  The caller enforces the deadline / drain-barrier / space
    conditions and never defers past them.
    """
    if run <= 0:
        return 0
    # only the tail can be carried, so only the tail needs scanning: a
    # 1-page suffix spans at most ceil(ps/entry_data) entries per group and
    # a handful of groups — scanning the whole batch here would duplicate
    # build_plan's O(run) scan for a decision about the last page.  A scan
    # landing mid-group sees that group's followers as holes and skips
    # them, so `groups` holds only whole groups, never a truncated one.
    window = min(run, 4 * (-(-policy.page_size // policy.entry_data)) + 8)
    lo_idx = start + run - window
    # whole committed groups of the window: [nentries, fdid, lo, hi)
    groups: List[list] = []
    for e in shard.scan_committed(lo_idx, start + run):
        if e.cg == CG_HEAD:
            groups.append([1 + e.nfollow, e.fdid, e.off, e.off + e.length])
        elif groups:
            g = groups[-1]
            g[2] = min(g[2], e.off)
            g[3] = max(g[3], e.off + e.length)
    ps = policy.page_size
    defer = 0
    lo = hi = fdid = None
    for cnt, fid, glo, ghi in reversed(groups):
        if fid == META_FDID:
            break                       # namespace record: never carried (it
            #                             is not file bytes, and holding it
            #                             back would delay its retirement)
        if ghi <= glo:
            break                       # empty group: nothing to carry
        if lo is None:
            nlo, nhi = glo, ghi
        elif fid != fdid or ghi < lo or glo > hi:
            break                       # different file / not contiguous
        else:
            nlo, nhi = min(lo, glo), max(hi, ghi)
        if nlo // ps != (nhi - 1) // ps:
            break                       # crosses the open page: close it
        lo, hi, fdid = nlo, nhi, fid
        defer += cnt
    return defer


def build_plan(shard: LogShard, start: int, run: int,
               resolve_file: Callable[[int], Optional[object]],
               policy: Policy, *, abort: Optional[AbortFn] = None
               ) -> Optional[DrainPlan]:
    """Phase 1: group the batch's committed entries by (file, page), merge
    them into page images, and coalesce page runs into extents.

    Returns ``None`` if ``abort`` fired (power loss / fault injection):
    nothing has been written or retired, the log replays the batch.
    """
    ps = policy.page_size
    plan = DrainPlan(shard.sid, start, run)
    accs: Dict[int, _FileAcc] = {}      # id(file) -> accumulator
    order: List[_FileAcc] = []
    for e in shard.scan_committed(start, start + run):
        if abort is not None and abort(PLAN_ENTRY):
            return None
        if e.fdid == META_FDID:
            plan.meta_entries += 1    # applied namespace record: retire only
            continue
        f = resolve_file(e.fdid)
        if f is None:                   # orphan (file force-closed): drop
            plan.orphans += 1
            continue
        acc = accs.get(id(f))
        if acc is None:
            acc = accs[id(f)] = _FileAcc(f)
            order.append(acc)
        acc.entries += 1
        acc.nbytes += e.length
        if e.length == 0:
            continue
        if not policy.drain_coalesce:
            acc.raw.append((e.off, bytes(e.data), e.idx))
            continue
        p0, p1 = e.off // ps, (e.off + e.length - 1) // ps
        for p in range(p0, p1 + 1):
            img = acc.pages.get(p)
            if img is None:
                img = acc.pages[p] = _PageImage(ps)
            base = p * ps
            s, t = max(e.off, base), min(e.off + e.length, base + ps)
            img.add(s - base, t - base, e.data[s - e.off:t - e.off], e.idx)

    for acc in order:
        fp = FilePlan(acc.file)
        fp.entries = acc.entries
        fp.nbytes = acc.nbytes
        fp.extents = (_coalesced_extents(acc, ps, policy.coalesce_max_extent)
                      if policy.drain_coalesce else _raw_extents(acc, ps))
        plan.files.append(fp)
    return plan


def _raw_extents(acc: _FileAcc, ps: int) -> List[Extent]:
    """Entry-at-a-time degenerate plan (``drain_coalesce=False``): one
    extent per log entry, exactly the paper's per-entry forwarding — kept
    as the measurable baseline for the coalescing win."""
    out = []
    for off, data, idx in acc.raw:
        pages = list(range(off // ps, (off + max(len(data), 1) - 1) // ps + 1))
        out.append(Extent(off, bytearray(data), pages,
                          {p: [idx] for p in pages}))
    return out


def _coalesced_extents(acc: _FileAcc, ps: int, max_extent: int) -> List[Extent]:
    """Flatten materialized page images into maximal contiguous extents."""
    out: List[Extent] = []
    cur_off = cur_end = 0
    cur_data: Optional[bytearray] = None
    cur_pages: List[int] = []
    cur_retire: Dict[int, List[int]] = {}

    def flush():
        nonlocal cur_data
        if cur_data is not None:
            out.append(Extent(cur_off, cur_data, cur_pages, cur_retire))
            cur_data = None

    for p in sorted(acc.pages):
        img = acc.pages[p]
        base = p * ps
        for s, e in img.ranges:
            abs_s, abs_e = base + s, base + e
            # every contributing entry's bytes on this page are contiguous,
            # so each span lies inside exactly one merged range
            idxs = [idx for idx, a, b in img.spans if s <= a and b <= e]
            if (cur_data is not None and abs_s == cur_end
                    and len(cur_data) + (abs_e - abs_s) <= max_extent):
                cur_data += img.buf[s:e]
                cur_end = abs_e
                if not cur_pages or cur_pages[-1] != p:
                    cur_pages.append(p)
                cur_retire.setdefault(p, []).extend(idxs)
            else:
                flush()
                cur_off, cur_end = abs_s, abs_e
                cur_data = bytearray(img.buf[s:e])
                cur_pages = [p]
                cur_retire = {p: list(idxs)}
    flush()
    return out


def apply_plan(plan: DrainPlan, policy: Policy, *,
               abort: Optional[AbortFn] = None,
               stats=None) -> Optional[Dict[object, int]]:
    """Phase 2: issue the extent writes and retire the dirty-page index.

    Per file: take the cleanup locks of every covered page (ascending — the
    same total order the write path uses, and drain threads of different
    shards never share a page, so there is no cycle), issue one vectored
    ``pwritev`` when the backend supports it (else per-extent ``pwrite``),
    then drop the batch's refs from each covered page.  Returns
    ``{file: entries_drained}``, or ``None`` on abort — in which case the
    log is *not* consumed and recovery replays everything (idempotent).
    """
    drained: Dict[object, int] = {}
    for fp in plan.files:
        if abort is not None and abort(APPLY_FILE):
            return None
        f = fp.file
        pwritev = getattr(f.backend, "pwritev", None)
        if policy.drain_coalesce and pwritev is not None:
            ok = _apply_vectored(plan, fp, pwritev, abort, stats)
        else:
            ok = _apply_serial(plan, fp, abort, stats)
        if not ok:
            return None
        drained[f] = fp.entries
    return drained


def _lock_descs(f, pages: List[int]):
    """Cleanup locks for ``pages``, ascending; returns [(page, desc)]."""
    if f.radix is None:
        return []
    descs = []
    for p in pages:
        d = f.radix.get_or_create(p)
        d.cleanup_lock.acquire()
        descs.append((p, d))
    return descs


# extents per pwritev call / per cleanup-lock hold: big enough that the
# syscall amortization is intact (64 segments per call), small enough that
# a huge batch against one file does not hold thousands of page locks
# across a device write and starve dirty-miss readers for the whole batch
VEC_CHUNK = 64


def _apply_vectored(plan, fp, pwritev, abort, stats) -> bool:
    """A file's extents in chunks: one lock hold + one pwritev per chunk."""
    obs = getattr(stats, "obs", None)
    lv2 = obs is not None and obs.prof.lv2
    for i in range(0, len(fp.extents), VEC_CHUNK):
        chunk = fp.extents[i:i + VEC_CHUNK]
        if abort is not None and abort(APPLY_EXTENT):
            return False
        pages = sorted({p for ext in chunk for p in ext.pages})
        descs = _lock_descs(fp.file, pages)
        dmap = dict(descs)
        try:
            t0 = time.perf_counter_ns() if lv2 else 0
            pwritev([(ext.data, ext.off) for ext in chunk])
            if lv2:
                obs.prof.h_drain_pwritev.record_ns(
                    time.perf_counter_ns() - t0)
            if stats is not None:
                stats.stats_pwritevs += 1
                stats.stats_extents += len(chunk)
            if abort is not None and abort(APPLY_RETIRE):
                return False
            for ext in chunk:
                for p, idxs in ext.retire.items():
                    d = dmap.get(p)
                    if d is not None:
                        d.retire_refs(plan.sid, set(idxs))
        finally:
            for _p, d in reversed(descs):
                d.cleanup_lock.release()
    return True


def _apply_serial(plan, fp, abort, stats) -> bool:
    """Per-extent pwrite + retire (legacy mode, or backend without pwritev)."""
    obs = getattr(stats, "obs", None)
    lv2 = obs is not None and obs.prof.lv2
    for ext in fp.extents:
        if abort is not None and abort(APPLY_EXTENT):
            return False
        descs = _lock_descs(fp.file, ext.pages)
        try:
            t0 = time.perf_counter_ns() if lv2 else 0
            fp.file.backend.pwrite(bytes(ext.data), ext.off)
            if lv2:
                obs.prof.h_drain_pwritev.record_ns(
                    time.perf_counter_ns() - t0)
            if stats is not None:
                stats.stats_extents += 1
            if abort is not None and abort(APPLY_RETIRE):
                return False
            for p, d in descs:
                idxs = ext.retire.get(p)
                if idxs:
                    d.retire_refs(plan.sid, set(idxs))
        finally:
            for _p, d in reversed(descs):
                d.cleanup_lock.release()
    return True


# --------------------------------------------------------------------------
class _SyncState:
    __slots__ = ("cond", "running", "started", "done", "waiters", "errors",
                 "__weakref__")

    GUARDED_BY = {
        "running": "cond", "started": "cond", "done": "cond",
        "errors": "cond",
        # guarded by the OWNING SCHEDULER's _lock (not expressible as a
        # self attribute): every touch happens inside the scheduler's
        # registration/teardown sections, whose lock edges order them
        "waiters": None,
    }

    def __init__(self):
        self.cond = locking.make_condition("leaf:fsync_epoch")
        self.running = False          # guarded-by: cond
        self.started = 0              # epochs started; guarded-by: cond
        self.done = 0                 # epochs completed (success OR
        #                               failure); guarded-by: cond
        self.waiters = 0              # guarded-by: scheduler._lock
        self.errors: Dict[int, BaseException] = {}   # epoch -> fsync error
        #                                              guarded-by: cond


class FsyncEpochScheduler:
    """Merges concurrent fsyncs of the same backend file into epochs.

    A caller's pwrites finished before it asked to fsync, so any fsync that
    *starts* afterwards covers them — but one already in flight may not.
    Each caller therefore waits for epoch ``started + 1`` (as observed at
    arrival): if no fsync is running it leads that epoch immediately; if
    one is running, every caller that arrives meanwhile shares the single
    next epoch — K shard drain threads fsyncing one backend file collapse
    to at most two device fsyncs instead of K.
    """

    GUARDED_BY = {
        "_state": "_lock",
        "stats_requests": "_lock", "stats_issued": "_lock",
    }

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = locking.make_lock("leaf:fsync_sched")
        self._state: Dict[int, _SyncState] = {}   # id(backend) -> state
        #                                           guarded-by: _lock
        self.stats_requests = 0                   # guarded-by: _lock
        self.stats_issued = 0                     # guarded-by: _lock

    @property
    def stats_merged(self) -> int:
        with self._lock:
            return self.stats_requests - self.stats_issued

    @property
    def stats_issued_snapshot(self) -> int:
        """Locked read of ``stats_issued`` for cross-thread reporting."""
        with self._lock:
            return self.stats_issued

    def fsync(self, backend) -> None:
        if not self.enabled:
            with self._lock:
                self.stats_requests += 1
                self.stats_issued += 1
            backend.fsync()
            return
        key = id(backend)
        with self._lock:
            self.stats_requests += 1
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = _SyncState()
            st.waiters += 1
        try:
            with st.cond:
                need = st.started + 1
                while st.done < need:
                    if not st.running:
                        st.running = True
                        st.started += 1
                        epoch = st.started
                        st.cond.release()
                        exc: Optional[BaseException] = None
                        try:
                            backend.fsync()
                        except BaseException as e:
                            exc = e
                        finally:
                            st.cond.acquire()
                            st.running = False
                            st.done = epoch
                            if exc is not None:
                                st.errors[epoch] = exc
                            st.cond.notify_all()
                        with self._lock:
                            self.stats_issued += 1
                    else:
                        st.cond.wait()
                # epochs complete in order, so epoch `need` is the one that
                # covered this caller's writes: a failure there must reach
                # EVERY waiter that shared it, not just the leader —
                # otherwise a merged drain thread would retire log entries
                # whose data never became durable
                err = st.errors.get(need)
                if err is not None:
                    raise err
        finally:
            with self._lock:
                st.waiters -= 1
                if st.waiters == 0 and not st.running:
                    self._state.pop(key, None)
