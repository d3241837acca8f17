"""Volatile read cache (paper §II-C): page descriptors in a radix tree,
page states {loaded, unloaded-clean, unloaded-dirty} via a per-page
**dirty-page index** (the ordered list of live log-entry refs touching the
page — a strict refinement of the paper's dirty *counter*), and an LRU
approximation with accessed flags (§II-D "scalable data structures").

The index is maintained at both ends of an entry's life: the write path
(``api._pwrite_op``) appends an :class:`~repro.core.log.EntryRef` to every
page the entry overlaps, and the drain engine (:mod:`repro.core.drain`)
retires the page's refs once the page's bytes are on the slow tier.  A
dirty-miss read therefore replays exactly the E live entries of that page —
O(E), where the dirty-counter design had to rescan the whole log to find
them.  The drain planner materializes page images from the same index.

CPython notes: the paper gets scalability from CAS-based lock-free inserts
and per-page locks.  Under the GIL, single bytecode dict/list mutations are
atomic; we keep the paper's *structure* (radix tree, per-page atomic +
cleanup locks, second-chance LRU with try-lock eviction) and use a short
insert lock where the paper uses CAS.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from repro_torch.core import locking


class AtomicInt:
    __slots__ = ("_v", "_lock")

    def __init__(self, v: int = 0):
        self._v = v
        self._lock = locking.make_lock("leaf:atomic_int")

    def inc(self, d: int = 1) -> int:
        with self._lock:
            self._v += d
            return self._v

    def dec(self, d: int = 1) -> int:
        return self.inc(-d)

    def get(self) -> int:
        return self._v


class PageContent:
    """A cached page buffer; recycled through the LRU queue."""

    __slots__ = ("data", "desc")

    def __init__(self, page_size: int):
        self.data = bytearray(page_size)
        self.desc: Optional["PageDesc"] = None


class PageDesc:
    """Page descriptor (paper Table II / Fig. 2).

    States: loaded (content is not None), unloaded-dirty (content None,
    ``entries`` non-empty), unloaded-clean (content None, ``entries`` empty).

    ``entries`` is the dirty-page index: the live log-entry refs whose bytes
    overlap this page, in commit (``seq``) order.  Appends happen under the
    page's ``atomic_lock`` (the writer draws its seq while holding it, so
    list order == seq order); retirement happens under ``cleanup_lock``; the
    dedicated ``ref_lock`` makes the one remaining pairing — writer append
    vs drain retire — safe without coupling those two locks.
    """

    __slots__ = ("page_no", "atomic_lock", "cleanup_lock", "ref_lock",
                 "entries", "content", "accessed", "prefetched",
                 "__weakref__")

    GUARDED_BY = {
        # rebound/appended under ref_lock; the dirty_refs length probe is
        # a lock-free read by design (callers hold atomic_lock, and a
        # stale length only delays a replay decision)
        "entries": "write:ref_lock",
        "content": "atomic_lock",
        # second-chance recency hints: racy by design (the paper's clock
        # approximation) — a lost flag costs one early eviction at most
        "accessed": locking.VOLATILE, "prefetched": locking.VOLATILE,
    }

    def __init__(self, page_no: int):
        self.page_no = page_no
        # write/read atomicity (§II-D); ascending page order when stacked
        self.atomic_lock = locking.make_lock("page_atomic", order_key=page_no)
        # vs cleanup thread (§II-D); ascending page order when stacked
        self.cleanup_lock = locking.make_lock("page_cleanup",
                                              order_key=page_no)
        # writer append vs drain retire
        self.ref_lock = locking.make_lock("leaf:ref")
        self.entries: list = []                # live EntryRefs, seq order
        #                                        guarded-by: write:ref_lock
        self.content: Optional[PageContent] = None  # guarded-by: atomic_lock
        self.accessed = False                  # guarded-by: volatile (hint)
        self.prefetched = False                # loaded by readahead, unread
        #                                        guarded-by: volatile (hint)

    def add_ref(self, ref) -> None:
        """Write path: register a just-committed entry on this page."""
        with self.ref_lock:
            self.entries.append(ref)

    def retire_refs(self, sid: int, idxs) -> int:
        """Drain path: drop the refs of shard ``sid`` whose monotonic index
        is in ``idxs`` — their bytes reached the backend.  Returns the number
        retired (order of survivors is preserved, so the list stays
        seq-sorted)."""
        with self.ref_lock:
            keep = [r for r in self.entries
                    if r.sid != sid or r.idx not in idxs]
            retired = len(self.entries) - len(keep)
            if retired:
                self.entries = keep
            return retired

    def snapshot_refs(self) -> list:
        with self.ref_lock:
            return list(self.entries)

    @property
    def dirty_refs(self) -> int:
        return len(self.entries)


class RadixTree:
    """Radix tree keyed by page number (paper §II-C, like NOVA).

    Fanout 64 (6 bits/level).  Nodes are fixed-size lists; descriptors are
    created lazily on first touch and never removed until the tree is freed
    on close (paper §II-D), which is what makes lock-free lookup safe.
    """

    FANOUT_BITS = 6
    FANOUT = 1 << FANOUT_BITS

    GUARDED_BY = {
        # immutable-node publishes under the insert lock; lookups read
        # lock-free (descriptors are never removed until the tree dies)
        "_root": "write:_insert_lock", "_height": "write:_insert_lock",
    }

    def __init__(self):
        self._root: list = [None] * self.FANOUT
        self._height = 1                     # levels below root
        #                                      (both guarded-by:
        #                                      write:_insert_lock)
        self._insert_lock = locking.make_lock("leaf:radix")

    def _capacity_bits(self) -> int:
        return self.FANOUT_BITS * self._height

    def get(self, key: int) -> Optional[PageDesc]:
        if key >> self._capacity_bits():
            return None
        node = self._root
        for level in range(self._height - 1, -1, -1):
            node = node[(key >> (level * self.FANOUT_BITS)) & (self.FANOUT - 1)]
            if node is None:
                return None
        return node  # type: ignore[return-value]

    def get_or_create(self, key: int) -> PageDesc:
        if key < 0:
            # a negative key would right-shift to -1 forever and grow the
            # tree without bound; offsets are validated upstream (EINVAL)
            raise ValueError(f"negative page number {key}")
        found = self.get(key)
        if found is not None:
            return found
        with self._insert_lock:
            while key >> self._capacity_bits():   # grow upward
                new_root: list = [None] * self.FANOUT
                new_root[0] = self._root
                self._root = new_root
                self._height += 1
            node = self._root
            for level in range(self._height - 1, 0, -1):
                slot = (key >> (level * self.FANOUT_BITS)) & (self.FANOUT - 1)
                if node[slot] is None:
                    node[slot] = [None] * self.FANOUT
                node = node[slot]
            slot = key & (self.FANOUT - 1)
            if node[slot] is None:
                node[slot] = PageDesc(key)
            return node[slot]

    def iter_descs(self):
        """Every descriptor currently in the tree (ascending page order).

        Safe under the GIL concurrently with inserts (nodes are fixed-size
        lists mutated by slot assignment); descriptors inserted during the
        walk may or may not be yielded — callers that need a fixed point
        (e.g. the O_TRUNC purge) serialize writers at a higher level.
        """
        def walk(node, depth):
            for child in node:
                if child is None:
                    continue
                if depth == 1:
                    yield child
                else:
                    yield from walk(child, depth - 1)
        yield from walk(self._root, self._height)


class LRUCache:
    """Second-chance LRU over page contents (paper §II-D).

    Eviction uses *try*-acquire on the victim's atomic lock: a busy victim is
    re-enqueued and the next one is tried, which removes the lock-ordering
    cycle between two concurrent misses.
    """

    GUARDED_BY = {
        "_queue": "_lock", "_allocated": "_lock",
        "stats_evictions": "_lock", "stats_hits": "_lock",
        "stats_misses": "_lock",
    }

    def __init__(self, capacity: int, page_size: int):
        self.capacity = max(2, capacity)
        self.page_size = page_size
        self._queue: deque[PageContent] = deque()
        self._lock = locking.make_lock("leaf:lru")   # the paper's "LRU lock"
        # guarded-by: _lock — pool state and the hit/miss/eviction counters
        # (readers use note_hit/note_miss/snapshot_stats, never the bare
        # fields: the old bare `lru.stats_hits += 1` under two different
        # page locks was a lost-update race)
        self._allocated = 0
        self.stats_evictions = 0
        self.stats_hits = 0
        self.stats_misses = 0

    def acquire_buffer(self) -> PageContent:
        """Return a free page buffer, evicting if at capacity.

        Overflow allocations (taken when every victim is pinned) ratchet
        ``_allocated`` above ``capacity``; each later acquire makes one
        opportunistic shrink attempt, so the pool converges back to its
        bound once the pinning burst is over."""
        content = self._acquire_one()
        self._shrink_one()
        return content

    def _pop_victim(self) -> tuple:
        """One step of the second-chance protocol: pop a queue entry and
        try to detach it.  Returns ``(status, content)`` where status is
        ``"empty"`` (queue exhausted), ``"free"``/``"evicted"`` (content is
        a usable buffer), or ``"busy"``/``"hot"`` (victim skipped and
        requeued)."""
        with self._lock:
            if not self._queue:
                return "empty", None
            content = self._queue.popleft()
            desc = content.desc
            if desc is None:                   # already detached
                return "free", content
            if not desc.atomic_lock.acquire(blocking=False):
                self._queue.append(content)
                return "busy", None
        try:
            if desc.accessed:                  # second chance
                desc.accessed = False
                with self._lock:
                    self._queue.append(content)
                return "hot", None
            desc.content = None                # -> unloaded-{clean,dirty}
            content.desc = None
            with self._lock:
                # under _lock, not just the victim's atomic_lock: two
                # concurrent evictions of different pages would race here
                self.stats_evictions += 1
            return "evicted", content
        finally:
            desc.atomic_lock.release()

    def _acquire_one(self) -> PageContent:
        with self._lock:
            if self._allocated < self.capacity:
                self._allocated += 1
                return PageContent(self.page_size)
            scans = 2 * len(self._queue) + 4   # two second-chance passes
        while scans > 0:
            status, content = self._pop_victim()
            if status == "empty":
                break
            if content is not None:
                return content
            scans -= 1
        # everything pinned (or busy-locked by this very caller, e.g. an
        # extent load holding its pages' atomic locks): overflow rather
        # than livelock on our own locks
        with self._lock:
            self._allocated += 1
        return PageContent(self.page_size)

    def _shrink_one(self) -> None:
        """Drop one reclaimable buffer while over capacity (see
        :meth:`acquire_buffer`); a no-op at or under the bound."""
        with self._lock:
            if self._allocated <= self.capacity:
                return
        _status, content = self._pop_victim()
        if content is not None:                # dropped, not reused
            with self._lock:
                self._allocated -= 1

    def acquire_buffers(self, count: int) -> list:
        """``count`` free page buffers for a multi-page (extent) load.

        Safe to call while holding the atomic locks of the pages about to
        be loaded: eviction try-locks victims and the bounded scan in
        :meth:`acquire_buffer` falls back to overflow allocation instead of
        spinning on the caller's own locked pages.
        """
        return [self.acquire_buffer() for _ in range(count)]

    def attach(self, desc: PageDesc, content: PageContent) -> None:
        content.desc = desc
        desc.content = content
        desc.accessed = True
        with self._lock:
            self._queue.append(content)

    def note_hit(self) -> None:
        """Count a read-cache hit.  Call sites used to bump ``stats_hits``
        directly while holding only their page's atomic lock — two hits on
        different pages lost updates; the LRU lock makes it a counter."""
        with self._lock:
            self.stats_hits += 1

    def note_miss(self) -> None:
        with self._lock:
            self.stats_misses += 1

    def snapshot_stats(self) -> dict:
        """Coherent copy of the cache counters for api.stats()."""
        with self._lock:
            return {
                "hits": self.stats_hits,
                "misses": self.stats_misses,
                "evictions": self.stats_evictions,
                "allocated": self._allocated,
            }

    def drop_all(self) -> None:
        with self._lock:
            for c in self._queue:
                if c.desc is not None:
                    c.desc.content = None
                    c.desc = None
            self._queue.clear()
            self._allocated = 0
