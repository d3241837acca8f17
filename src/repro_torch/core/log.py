"""The NVMM write log (paper §II-B, §II-D, §III Algorithm 1), sharded.

Layout inside the NVMM region (VERSION 4)::

    [superblock + shard tail table | fd-path table | route table
     | paged region (page_frames frames; empty when page_frames == 0)
     | shard 0 | ... | shard K-1]

The *paged region* (VERSION 4, :mod:`repro.core.pager`) is the second
persistence mode: per-file page frames whose overwrites are absorbed in
place instead of appended here.  The two modes compose under one ordering
rule — every frame commit draws its ``seq`` from the same global
:meth:`NVLog.next_seq` counter as log groups, so recovery merges frame
images and log groups into a single ascending-seq replay.  Routing
invariant: a (file, page) is persisted by exactly one mode at a time — a
frame is only materialized for a page with zero live log refs, a framed
page's writes never append to the log, and mode flips happen behind the
per-file freeze + drain barrier — so for any page either the log holds the
newest committed bytes, or the frame does (with a strictly larger seq than
any drained log entry for that page); never a mix that recovery could
interleave wrongly.

The region is partitioned into ``K = policy.shards`` independent sub-logs
(*shards*), each a circular array of fixed-size entries with its own
monotonic indices, its own persistent tail slot in the superblock's shard
table (one cacheline per shard — no false sharing of tail updates), and its
own volatile head/tail pair, i.e. free-space accounting.  ``K == 1`` is
exactly the paper's single circular log.  Writes are routed to a shard by
(fdid, offset) — see :mod:`repro.core.policy` — so unrelated files never
contend on the same fetch-and-add and each shard is drained by its own
cleanup thread (:class:`repro.core.cleanup.CleanupPool`).

Entries are fixed-size (paper §II-D: fixed size is what lets a thread commit
its entry independently of uncommitted neighbours, and lets recovery skip an
uncommitted hole and keep scanning).  Each 48-byte entry header packs the
commit flag and the group index into a single word ``cg`` that lives in the
first cacheline of the entry (paper: one flush, no extra cache miss):

    cg == 0        free, or allocated-but-uncommitted
    cg == 1        committed group head (or single-entry write)
    cg == idx + 2  committed follower of the group whose head has monotonic
                   index ``idx`` (indices are per shard)

The header also carries ``seq``, a *global* commit sequence number shared by
all shards.  ``seq`` is drawn while holding the shard's allocation lock, so
within one shard log order and seq order agree; across shards ``seq`` is the
merge key: recovery scans each shard independently and replays the union of
committed groups in ascending ``seq``, which restores the durable-
linearizability order per file location (any two overlapping writes are
routed to the same shard, so their seqs are also ordered by that shard's
log).  Per-shard indices are monotonic u64; the slot of index ``i`` is
``i % N`` with ``N = policy.entries_per_shard``.

A write larger than one entry allocates a *contiguous* block of entries in
one shard with a single fetch-and-add and commits atomically through the
head's commit flag alone (paper §II-D), in this order:

    fill followers -> pwb -> fill head (cg=0) -> pwb -> pfence
    -> head.cg = 1 -> pwb -> psync        (durable linearizability, §III)

Two tails per shard (paper §III "cleanup thread"):
  * ``persistent_tail`` in NVMM (shard table slot) — where recovery starts
    scanning this shard;
  * ``volatile_tail`` in DRAM — what writers check for free space.  An entry
    is recycled for writers only after it is durably consumed
    (cg zeroed + persistent tail advanced + pwb/pfence).
"""
from __future__ import annotations

import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional

from repro_torch.core import locking
from repro_torch.core.nvmm import NVMM
from repro_torch.core.policy import Policy, SUPERBLOCK
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics

MAGIC = 0x4E56_4341_4348_4532  # "NVCACHE2" (v1 was the unsharded layout)
VERSION = 5                    # v3 added the persisted route table region;
#                                v4 added the paged region (dual persistence);
#                                v5 added the flight-recorder ring (repro.obs)

_SB = struct.Struct("<QIIIIIIII")  # magic, ver, entry_size, entries/shard,
#                                    shards, fd_max, path_max, page_frames,
#                                    flight_records
_HDR = struct.Struct("<QQQIIII")  # cg, seq, off, fdid, length, nfollow, crc
HDR_SIZE = 48                     # header struct (44B) padded to 48
assert _HDR.size <= HDR_SIZE

CG_FREE = 0
CG_HEAD = 1

# ---------------------------------------------------------------- metadata
# Namespace (metadata) operations are first-class log entries: they carry
# the sentinel fdid below instead of a real file-table slot, and their
# payload is a :data:`_META`-encoded record instead of file bytes.  They
# commit through the exact same per-shard alloc/fill/commit protocol as
# data writes — drawing a global ``seq`` under the shard allocation lock —
# so recovery's cross-shard seq-merge serializes them against every data
# group (see :mod:`repro.core.namespace` for the protocol and its
# old-or-new guarantee).
META_FDID = 0xFFFF_FFFF            # u32 sentinel; real fdids are < fd_max
META_NO_FDID = 0xFFFF_FFFE         # payload fdid for ops on paths with no
#                                    live File (a closed, fully-drained
#                                    file): no in-log data group can carry
#                                    it, so recovery's dead-fdid tracking
#                                    ignores it (0 is a REAL fdid slot)

MOP_CREATE = 1                     # bind a path into the namespace
MOP_RENAME = 2                     # atomically move path a over path b
MOP_UNLINK = 3                     # remove path a
MOP_FTRUNCATE = 4                  # set path a's length to aux

_META = struct.Struct("<BIQHH")    # op, fdid, aux, len(a), len(b)


def encode_meta(op: int, fdid: int, aux: int, a: str, b: str = "") -> bytes:
    ra, rb = a.encode(), b.encode()
    return _META.pack(op, fdid, aux, len(ra), len(rb)) + ra + rb


def decode_meta(payload: bytes) -> tuple[int, int, int, str, str]:
    """Returns ``(op, fdid, aux, a, b)``; raises ValueError on a payload
    that does not parse (recovery drops such groups whole)."""
    if len(payload) < _META.size:
        raise ValueError("short metadata payload")
    op, fdid, aux, la, lb = _META.unpack_from(payload)
    if len(payload) < _META.size + la + lb:
        raise ValueError("truncated metadata payload")
    a = bytes(payload[_META.size:_META.size + la]).decode()
    b = bytes(payload[_META.size + la:_META.size + la + lb]).decode()
    return op, fdid, aux, a, b


class LogFullTimeout(RuntimeError):
    pass


class Entry:
    """Decoded view of a committed entry (header + payload memoryview)."""

    __slots__ = ("sid", "idx", "cg", "seq", "off", "fdid", "length", "nfollow",
                 "crc", "data")

    def __init__(self, sid, idx, cg, seq, off, fdid, length, nfollow, crc, data):
        self.sid = sid
        self.idx = idx
        self.cg = cg
        self.seq = seq
        self.off = off
        self.fdid = fdid
        self.length = length
        self.nfollow = nfollow
        self.crc = crc
        self.data = data  # memoryview of length bytes (valid until recycled)

    @property
    def is_meta(self) -> bool:
        """A namespace (metadata) entry rather than file data."""
        return self.fdid == META_FDID


class EntryRef:
    """Stable, recycle-safe handle to one live log entry.

    Per-shard indices are *monotonic* u64 (the slot of index ``i`` is
    ``i % N``), so ``(sid, idx)`` names one entry for the lifetime of the
    region: a recycled slot is refilled under a strictly larger index and a
    stale ref can never silently alias the new occupant — ``seq`` (and the
    header's off/length) double-check it.  The dirty-page index
    (:class:`repro.core.readcache.PageDesc`) holds these instead of payload
    copies; the payload is read back from NVMM via
    :meth:`NVLog.ref_payload`, which is valid exactly while the ref is live
    (refs are retired by the drain engine strictly before the entry is
    recycled).
    """

    __slots__ = ("sid", "idx", "seq", "off", "length")

    def __init__(self, sid: int, idx: int, seq: int, off: int, length: int):
        self.sid = sid
        self.idx = idx
        self.seq = seq
        self.off = off
        self.length = length

    def __repr__(self) -> str:  # debugging aid for index dumps
        return (f"EntryRef(sid={self.sid}, idx={self.idx}, seq={self.seq}, "
                f"off={self.off}, len={self.length})")


class LogShard:
    """One independent circular sub-log (the paper's whole log when K=1)."""

    GUARDED_BY = {
        # one shard lock, three faces: the conditions share _lock, so
        # holding any of them is the same mutual exclusion
        "head": ("_lock", "_space", "_committed"),
        "volatile_tail": ("_lock", "_space", "_committed"),
        "stats_appended": ("_lock", "_space", "_committed"),
        # internally synchronized / publish-before-threads (see __init__)
        "alloc_wait": locking.VOLATILE,
        "obs": locking.VOLATILE,
        # benign race: the EV_COMMIT sampling phase counter.  Concurrent
        # appenders may lose an increment, which only shifts which commit
        # the 1-in-16 sample lands on — never correctness, never a seq.
        "_commit_tick": locking.VOLATILE,
    }

    def __init__(self, nvmm: NVMM, policy: Policy, sid: int):
        self.nvmm = nvmm
        self.policy = policy
        self.sid = sid
        self.n = policy.entries_per_shard
        self.entry_size = policy.entry_size
        self.base = policy.shard_base(sid)
        self.tail_off = policy.shard_tail_off(sid)

        self._lock = locking.make_lock("shard")  # guards head/volatile_tail
        self._space = locking.make_condition("shard", self._lock)
        #                                       ^ writers wait for space
        self._committed = locking.make_condition("shard", self._lock)
        #                                       ^ drainer waits for work
        # guarded-by: _lock (via _space/_committed too) — the shard cursor
        # pair and the per-shard counters load_sample() snapshots
        self.head = 0                           # volatile head (paper §II-B fn1)
        self.volatile_tail = 0
        self.stats_appended = 0                 # entries ever reserved here
        # guarded-by: VOLATILE — the histogram is internally synchronized
        # (per-thread cells, repro.obs.metrics); one episode per log-full
        # wait, so the rebalance planner reads a real distribution instead
        # of a count-less duration sum.
        self.alloc_wait = metrics.Histogram("log.alloc_wait_us")
        # guarded-by: VOLATILE — the engine's ObsPlane, wired once by
        # NVCache before any writer or drain thread starts and read-only
        # after (publication rides the thread-start edge).  None when the
        # shard is used standalone (recovery, unit tests).
        self.obs = None
        self._commit_tick = 0                   # EV_COMMIT sampling phase

    def format(self) -> None:
        """Zero every entry header (cg == CG_FREE) and this shard's tail."""
        for i in range(self.n):
            self.nvmm.store(self.base + i * self.entry_size, b"\x00" * HDR_SIZE)
            self.nvmm.pwb(self.base + i * self.entry_size, HDR_SIZE)
        self.nvmm.store_u64(self.tail_off, 0)
        self.nvmm.pwb(self.tail_off, 8)
        # format/attach run before any writer or drain thread exists —
        # single-owner setup, no lock needed
        self.head = 0                          # lint: allow(L004)
        self.volatile_tail = 0                 # lint: allow(L004)

    def attach(self) -> int:
        """Adopt on-NVMM state after a restart; returns the max committed seq
        seen (0 if the shard is empty)."""
        ptail = self.persistent_tail
        # pre-start single-owner adoption (see format)
        self.head = ptail                      # lint: allow(L004)
        self.volatile_tail = ptail             # lint: allow(L004)
        max_seq = 0
        for e in self.scan_committed(ptail, ptail + self.n):
            max_seq = max(max_seq, e.seq)
            if e.idx + 1 > self.head:          # lint: allow(L004)
                self.head = e.idx + 1          # lint: allow(L004)
        return max_seq

    @property
    def persistent_tail(self) -> int:
        return self.nvmm.load_u64(self.tail_off)

    def _store_persistent_tail(self, val: int) -> None:
        self.nvmm.store_u64(self.tail_off, val)
        self.nvmm.pwb(self.tail_off, 8)

    # ---------------------------------------------------------- entry codec
    def _eoff(self, idx: int) -> int:
        return self.base + (idx % self.n) * self.entry_size

    def read_cg(self, idx: int) -> int:
        return self.nvmm.load_u64(self._eoff(idx))

    def read_entry(self, idx: int) -> Entry:
        off = self._eoff(idx)
        cg, seq, foff, fdid, length, nfollow, crc = _HDR.unpack_from(
            self.nvmm.load(off, _HDR.size))
        data = self.nvmm.load(off + HDR_SIZE, length)
        return Entry(self.sid, idx, cg, seq, foff, fdid, length, nfollow, crc, data)

    def is_committed(self, idx: int) -> bool:
        """Committed = head with cg==1, or follower whose head has cg==1."""
        cg = self.read_cg(idx)
        if cg == CG_HEAD:
            return True
        if cg >= 2:
            return self.read_cg(cg - 2) == CG_HEAD
        return False

    # ------------------------------------------------------------ allocation
    def alloc(self, k: int, timeout: Optional[float] = None,
              seq_source=None) -> tuple[int, int]:
        """Reserve ``k`` contiguous entries; returns (index, seq).

        Blocks while the shard is full (paper Alg. 1 ``next_entry`` line 37).
        ``timeout`` bounds the TOTAL wait as a monotonic deadline — each
        ``Condition.wait`` gets only the remaining budget, so spurious
        wakeups and near-miss frees (woken, still full, wait again) cannot
        extend the wait beyond ``timeout``.  ``seq_source`` is drawn
        *inside* the allocation lock so that within this shard, allocation
        order == seq order (drain order and the recovery merge then agree
        for every pair of entries in one shard).
        """
        if k > self.n - 1:
            raise ValueError("write exceeds shard capacity; split upstream")
        deadline = None if timeout is None else time.monotonic() + timeout
        waited_ns = 0
        try:
            with self._space:
                while self.head + k - self.volatile_tail > self.n:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise LogFullTimeout(f"shard {self.sid} full")
                    t0 = time.monotonic_ns()
                    self._space.wait(timeout=remaining)
                    waited_ns += time.monotonic_ns() - t0
                idx = self.head
                self.head += k
                self.stats_appended += k
                seq = seq_source() if seq_source is not None else 0
                return idx, seq
        finally:
            if waited_ns:
                # one episode per log-full wait (including timed-out ones)
                self.alloc_wait.record_ns(waited_ns)
                obs = self.obs
                if obs is not None and obs.flight is not None:
                    obs.flight.record(obs_flight.EV_BACKPRESSURE,
                                      self.sid, waited_ns)

    @property
    def stats_alloc_wait_s(self) -> float:
        """Total time writers spent log-full (back-compat view over the
        ``log.alloc_wait_us`` histogram)."""
        return self.alloc_wait.sum_s

    def try_alloc(self, k: int, seq_source=None) -> Optional[tuple[int, int]]:
        with self._space:
            if self.head + k - self.volatile_tail > self.n:
                return None
            idx = self.head
            self.head += k
            self.stats_appended += k
            seq = seq_source() if seq_source is not None else 0
            return idx, seq

    # ---------------------------------------------------------------- write
    def fill_entry(self, idx: int, fdid: int, off: int, data: bytes, cg: int,
                   seq: int = 0) -> None:
        """Fill one entry (no commit).  ``cg`` is 0 for heads, head+2 for
        followers; ``nfollow`` is patched on the head before commit."""
        eoff = self._eoff(idx)
        crc = zlib.crc32(data) if self.policy.verify_crc else 0
        self.nvmm.store(eoff, _HDR.pack(cg, seq, off, fdid, len(data), 0, crc))
        self.nvmm.store(eoff + HDR_SIZE, data)
        self.nvmm.pwb(eoff, HDR_SIZE + len(data))

    def append(self, fdid: int, off: int, data: bytes, *, seq_source,
               timeout: Optional[float] = None,
               on_alloc=None) -> tuple[int, int, int]:
        """The paper's write-cache append: alloc, fill, commit.

        Returns ``(head_idx, k, seq)``.  On return the write is durable
        (synchronous durability) and ordered (durable linearizability).

        ``on_alloc(head, k, seq)`` runs after allocation but BEFORE the
        commit flag is set.  The write path registers the group's refs in
        the dirty-page index here: only once the commit makes the entries
        visible can the drain retire them, so retire always finds the refs
        — registering after ``append`` returned would race the drain the
        way the paper's dirty counter did (its fn. 4 transient negative),
        except an index cannot absorb a lost retirement the way a counter
        absorbs a transient negative.
        """
        ed = self.policy.entry_data
        k = max(1, -(-len(data) // ed))
        head, seq = self.alloc(k, timeout=timeout, seq_source=seq_source)
        if on_alloc is not None:
            on_alloc(head, k, seq)
        obs = self.obs
        lv2 = obs is not None and obs.prof.lv2
        t_fill = time.perf_counter_ns() if lv2 else 0
        # followers first (paper §II-D: they must be durable before the head
        # commit makes the whole group visible to recovery)
        for j in range(1, k):
            chunk = data[j * ed:(j + 1) * ed]
            self.fill_entry(head + j, fdid, off + j * ed, chunk, cg=head + 2,
                            seq=seq)
        self.fill_entry(head, fdid, off, data[:ed], cg=CG_FREE, seq=seq)
        # patch nfollow on the head before the commit flush
        eoff = self._eoff(head)
        self.nvmm.store(eoff + 32, struct.pack("<I", k - 1))
        self.nvmm.pwb(eoff, HDR_SIZE)
        self.nvmm.pfence()                    # entries durable before commit
        t_commit = time.perf_counter_ns() if lv2 else 0
        if lv2:
            obs.prof.h_fill.record_ns(t_commit - t_fill)
        self.nvmm.store_u64(eoff, CG_HEAD)    # commit the group
        self.nvmm.pwb(eoff, 8)
        self.nvmm.psync()                     # durable linearizability (§III)
        with self._lock:
            self._committed.notify_all()
        if lv2:
            obs.prof.h_commit.record_ns(time.perf_counter_ns() - t_commit)
        if obs is not None and obs.prof.lv1 and obs.flight is not None:
            # Sampled 1-in-16 per shard: commits are the only high-rate
            # flight event, and a per-group record would both dominate the
            # instrumented hot-path cost (~5µs pack+crc+store each) and
            # wrap the small ring in milliseconds.  Sampling keeps a
            # commit heartbeat in the forensic window (seq payloads show
            # the gaps) at 1/16th the cost; rare events stay unsampled.
            tick = self._commit_tick
            self._commit_tick = tick + 1
            if tick & 0xF == 0:
                obs.flight.record(obs_flight.EV_COMMIT, self.sid, seq,
                                  head % self.n, k)
        return head, k, seq

    # -------------------------------------------------- consumption (drain)
    def committed_run(self, start: int, limit: int) -> int:
        """Number of consecutive committed entries at ``start`` (whole groups
        only), capped at ``limit``.  Used by this shard's drain thread to
        build a batch; stops at the first uncommitted head (in-flight)."""
        count = 0
        with self._lock:
            head = self.head
        while count < limit and start + count < head:
            cg = self.read_cg(start + count)
            if cg != CG_HEAD:
                break  # hole: in-flight, uncommitted (wait for the writer)
            group = 1 + self.read_entry(start + count).nfollow
            if count + group > limit and count > 0:
                break
            count += group
        return count

    def wait_committed(self, min_entries: int, *, drain_event: threading.Event,
                       stop_event: threading.Event, poll: float = 0.05,
                       deferred: int = 0,
                       deadline_at: Optional[float] = None) -> int:
        """Block until >= min_entries consecutive committed entries exist at
        the persistent tail, or a drain/stop is requested.  Returns the run
        length found (0 if stopping).

        ``deferred`` entries at the tail were intentionally held back by the
        drain's batch-spanning coalescer: they alone are not "new work", so
        the wait ignores them until either fresh entries commit behind them
        (``run > deferred``), the carried extent's ``deadline_at``
        (monotonic seconds) expires, or a drain/stop is requested — the
        three events that close the open tail extent."""
        while True:
            run = self.committed_run(self.persistent_tail, self.policy.batch_max)
            if run > 0:
                if drain_event.is_set():
                    return run
                if run >= min_entries and run > deferred:
                    return run
                if deadline_at is not None and time.monotonic() >= deadline_at:
                    return run
                with self._lock:
                    used = self.head - self.volatile_tail
                if 2 * used >= self.n:
                    # log-full backpressure: writers may be blocked on
                    # recycling while the ready run is below batch_min
                    # (e.g. a small group ahead of one that exceeds
                    # batch_max) — never idle on a starving shard
                    return run
            if stop_event.is_set():
                return run
            timeout = poll
            if deadline_at is not None:
                timeout = min(poll, max(0.0, deadline_at - time.monotonic()))
            with self._committed:
                self._committed.wait(timeout=max(1e-4, timeout))

    def consume(self, start: int, count: int) -> None:
        """Durably retire ``count`` entries at ``start`` (== persistent tail).

        Paper cleanup step 2: zero the commit flags and advance the persistent
        tail with pwb/pfence; step 3: advance the volatile tail so writers can
        recycle the slots.
        """
        if start != self.persistent_tail:
            raise AssertionError("drain must consume at the persistent tail")
        for i in range(count):
            eoff = self._eoff(start + i)
            self.nvmm.store_u64(eoff, CG_FREE)
            self.nvmm.pwb(eoff, 8)
        self._store_persistent_tail(start + count)
        self.nvmm.pfence()
        with self._space:
            self.volatile_tail = start + count
            self._space.notify_all()

    # ------------------------------------------------------------------ scan
    def scan_committed(self, start: int, end: int) -> Iterator[Entry]:
        """Yield committed entries in ``[start, end)`` in shard-log order,
        skipping holes.  Safe concurrently with writers (an entry is only
        yielded when its group head is committed) — used by the dirty-miss
        procedure and by recovery."""
        idx = start
        while idx < end:
            cg = self.read_cg(idx)
            if cg == CG_HEAD:
                head = self.read_entry(idx)
                yield head
                for j in range(head.nfollow):
                    e = self.read_entry(idx + 1 + j)
                    if e.cg == idx + 2:
                        yield e
                idx += 1 + head.nfollow
            else:
                idx += 1

    def snapshot_bounds(self) -> tuple[int, int]:
        with self._lock:
            return self.volatile_tail, self.head

    @property
    def used_entries(self) -> int:
        with self._lock:
            return self.head - self.volatile_tail

    def load_sample(self) -> dict:
        """One rebalance-epoch load sample: live entries, drain backlog
        (committed-or-in-flight entries the drain has not yet retired), and
        the cumulative counters the sampler turns into per-epoch deltas."""
        with self._lock:
            head, vtail = self.head, self.volatile_tail
            appended = self.stats_appended
        # the alloc-wait histogram is internally synchronized: a real
        # distribution (count + sum), not a count-less duration sum
        waits = self.alloc_wait.count
        wait_ns = self.alloc_wait.sum_ns
        return {"sid": self.sid, "used": head - vtail,
                "queue": head - self.persistent_tail,
                "alloc_wait_s": wait_ns * 1e-9, "appended": appended,
                "alloc_waits": waits,
                "alloc_wait_mean_us": (wait_ns / waits) * 1e-3
                                      if waits else 0.0}

    def notify_committed(self) -> None:
        with self._committed:
            self._committed.notify_all()


class NVLog:
    """The sharded log facade: K :class:`LogShard` sub-logs, the global
    superblock + fd-path table, the global ``seq`` source, and write routing.
    """

    GUARDED_BY = {
        "_seq": "_seq_lock",
        # diagnostic counter read by the conftest full-scan guard after
        # the run; a racy live read only under-counts — and any full scan
        # on a hot path is itself the bug being guarded against
        "stats_full_scans": locking.VOLATILE,
    }

    def __init__(self, nvmm: NVMM, policy: Policy, *, format: bool = True,
                 adopt: bool = True):
        """``adopt=False`` (with ``format=False``) skips restoring the
        volatile heads/seq from a scan — for read-only consumers like
        recovery, which scans the shards itself anyway."""
        self.nvmm = nvmm
        self.policy = policy
        self.n = policy.entries_per_shard
        self.entry_size = policy.entry_size
        if nvmm.size < policy.nvmm_bytes:
            raise ValueError(f"NVMM region too small: {nvmm.size} < {policy.nvmm_bytes}")
        self.shards: List[LogShard] = [LogShard(nvmm, policy, s)
                                       for s in range(policy.shards)]
        self._seq_lock = locking.make_lock("leaf:seq")
        self._seq = 0
        self.stats_full_scans = 0   # whole-log scans (must stay off hot paths)
        self.router = None          # optional EpochRouter (adaptive routing);
        #                             None == the static formula below, the
        #                             PR 3 behavior bit for bit
        if format:
            self._format()
        else:
            self._check_superblock()
            if adopt:
                self._seq = max(sh.attach() for sh in self.shards)
                if policy.page_frames:
                    # frames draw from the same seq counter: never reuse a
                    # seq below a live frame's (recovery merges by seq)
                    from repro_torch.core.pager import max_frame_seq
                    self._seq = max(self._seq, max_frame_seq(nvmm, policy))
                # a persisted route record means a rebalance-enabled
                # instance installed overrides while (possibly) leaving
                # live entries in the overridden shards.  Honor it even if
                # this policy has shard_rebalance off: falling back to the
                # static route would send an overlapping write to a
                # different shard than the live entries it overlaps —
                # breaking the invariant the whole design rests on.  An
                # owner that enables rebalancing replaces this router with
                # its own (loaded from the same record, so routes agree).
                from repro_torch.core.router import EpochRouter, load_route_record
                epoch, table, shifts = load_route_record(nvmm, policy)
                if epoch or table or shifts:
                    # route-only (sampling=False): without a rebalance
                    # thread nobody would ever drain the load counters
                    self.router = EpochRouter(nvmm, policy, sampling=False)

    def next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    # ------------------------------------------------------------ superblock
    def _format(self) -> None:
        # zeroes everything below the shards — fd table, route table,
        # (VERSION 5) the flight-recorder ring, and (VERSION 4) every
        # paged-frame header, so a reformat frees frames
        self.nvmm.store(0, b"\x00" * self.policy.entries_base)
        self.nvmm.store(0, _SB.pack(MAGIC, VERSION, self.entry_size, self.n,
                                    self.policy.shards, self.policy.fd_max,
                                    self.policy.path_max,
                                    self.policy.page_frames,
                                    self.policy.flight_records))
        self.nvmm.pwb(0, self.policy.entries_base)
        for sh in self.shards:
            sh.format()
        self.nvmm.psync()
        # __init__-only helper: single-owner setup
        self._seq = 0                          # lint: allow(L004)

    def _check_superblock(self) -> None:
        magic, ver, esz, n, k, fdm, pm, pf, fr = _SB.unpack_from(
            self.nvmm.load(0, _SB.size))
        if magic != MAGIC or ver != VERSION:
            raise ValueError("not an NVCache log region")
        if esz != self.entry_size or n != self.n or k != self.policy.shards:
            raise ValueError("policy mismatch with on-NVMM superblock")
        if pf != self.policy.page_frames:
            raise ValueError("paged-region mismatch with on-NVMM superblock")
        if fr != self.policy.flight_records:
            raise ValueError("flight-ring mismatch with on-NVMM superblock")

    # ------------------------------------------------------------- fd table
    def fd_table_set(self, fdid: int, path: str) -> None:
        raw = path.encode()
        if len(raw) >= self.policy.path_max:
            raise ValueError("path too long for fd table")
        off = SUPERBLOCK + fdid * self.policy.path_max
        self.nvmm.store(off, raw + b"\x00" * (self.policy.path_max - len(raw)))
        self.nvmm.pwb(off, self.policy.path_max)
        self.nvmm.psync()

    def fd_table_get(self, fdid: int) -> Optional[str]:
        off = SUPERBLOCK + fdid * self.policy.path_max
        raw = bytes(self.nvmm.load(off, self.policy.path_max))
        raw = raw.split(b"\x00", 1)[0]
        return raw.decode() if raw else None

    def fd_table_clear(self) -> None:
        self.nvmm.store(SUPERBLOCK, b"\x00" * self.policy.fd_table_bytes)
        self.nvmm.pwb(SUPERBLOCK, self.policy.fd_table_bytes)
        self.nvmm.psync()

    # --------------------------------------------------------------- routing
    def route(self, fdid: int, off: int) -> int:
        """Map a write to a shard.  Overlapping writes always map to the same
        shard (per-file in "fdid" mode, per-stripe in "stripe" mode, where the
        caller splits writes at stripe boundaries).  With an
        :class:`repro.core.router.EpochRouter` installed the lookup goes
        through the current routing epoch's override table; migrations
        preserve the overlap invariant via the per-file drain barrier (see
        the router module docstring for the proof)."""
        if self.router is not None:
            return self.router.route(fdid, off)
        return self.policy.static_shard(fdid, off)

    def entries_needed(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.policy.entry_data))

    # ---------------------------------------------------------------- write
    def append(self, fdid: int, off: int, data: bytes,
               timeout: Optional[float] = None,
               shard: Optional[int] = None,
               on_alloc=None) -> tuple[int, int, int, int]:
        """Route and commit one write; returns ``(sid, head_idx, k, seq)``.

        ``on_alloc(sid, head, k, seq)`` runs pre-commit (see
        :meth:`LogShard.append`) — the write path's hook for registering
        the group in the dirty-page index before the drain can see it.
        """
        sid = self.route(fdid, off) if shard is None else shard
        if self.router is not None:
            self.router.note_append(fdid, off, self.entries_needed(len(data)))
        cb = None if on_alloc is None else (
            lambda head, k, seq: on_alloc(sid, head, k, seq))
        head, k, seq = self.shards[sid].append(fdid, off, data,
                                               seq_source=self.next_seq,
                                               timeout=timeout,
                                               on_alloc=cb)
        return sid, head, k, seq

    def append_meta(self, payload: bytes, *, route_key: str = "",
                    timeout: Optional[float] = None,
                    on_alloc=None) -> tuple[int, int, int, int]:
        """Commit one namespace (metadata) record as a log entry group.

        The record routes by a hash of its primary path — metadata ops
        never overlap data writes in the log-ordering sense (the caller
        quiesces the file behind the drain barrier first), so any shard is
        sound; hashing spreads unrelated namespace traffic.  The global
        ``seq`` drawn inside the shard lock is what orders the op against
        every data group for recovery's merge.  ``on_alloc(sid, head, k,
        seq)`` runs pre-commit, exactly like the data path's hook — the
        namespace registers its not-yet-applied marker there, before the
        drain can possibly see the entry.
        """
        sid = zlib.crc32(route_key.encode()) % self.policy.shards
        cb = None if on_alloc is None else (
            lambda head, k, seq: on_alloc(sid, head, k, seq))
        head, k, seq = self.shards[sid].append(META_FDID, 0, payload,
                                               seq_source=self.next_seq,
                                               timeout=timeout,
                                               on_alloc=cb)
        return sid, head, k, seq

    # ------------------------------------------------------------------ refs
    def group_refs(self, sid: int, head: int, k: int, seq: int, off: int,
                   nbytes: int) -> List[EntryRef]:
        """One :class:`EntryRef` per entry of a just-committed group, with
        the per-entry file offset/length split that :meth:`LogShard.append`
        used — the write path feeds these into the dirty-page index."""
        ed = self.policy.entry_data
        return [EntryRef(sid, head + j, seq, off + j * ed,
                         min(ed, nbytes - j * ed))
                for j in range(k)]

    def ref_payload(self, ref: EntryRef) -> memoryview:
        """Payload bytes of a *live* ref (dirty-miss replay).

        The caller must hold the page's cleanup lock, which orders it
        against the drain engine: a ref still present in a page's index has
        not been retired, so its entry cannot have been recycled.  The
        header check turns a protocol violation (reading through a stale
        ref) into a loud error instead of silently replaying another
        write's bytes.
        """
        sh = self.shards[ref.sid]
        eoff = sh._eoff(ref.idx)
        _cg, seq, foff, _fdid, length, _nf, _crc = _HDR.unpack_from(
            self.nvmm.load(eoff, _HDR.size))
        if seq != ref.seq or foff != ref.off or length != ref.length:
            raise RuntimeError(f"stale {ref!r}: entry slot was recycled "
                               f"(seq={seq} off={foff} len={length})")
        return self.nvmm.load(eoff + HDR_SIZE, length)

    # ------------------------------------------------------------------ scan
    def scan_all_committed(self) -> Iterator[Entry]:
        """Committed entries of every shard, in no particular cross-shard
        order (sort by ``(seq, idx)`` when ordering matters).  O(log) — kept
        for recovery-style consumers and diagnostics only; the read path
        uses the per-page dirty index instead (``stats_full_scans`` guards
        that in tests)."""
        self.stats_full_scans += 1
        for sh in self.shards:
            tail, head = sh.snapshot_bounds()
            yield from sh.scan_committed(tail, head)

    @property
    def used_entries(self) -> int:
        return sum(sh.used_entries for sh in self.shards)

    def verify_entry(self, e: Entry) -> bool:
        return (not self.policy.verify_crc) or zlib.crc32(bytes(e.data)) == e.crc

    # --------------------------------------------- single-shard conveniences
    # (protocol-level tests and the K=1 path address the log as one object)
    @property
    def persistent_tail(self) -> int:
        return self.shards[0].persistent_tail
