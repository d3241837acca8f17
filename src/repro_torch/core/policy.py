"""NVCache policy knobs (paper §IV-A defaults, scaled down in tests).

Paper defaults: 4 KiB entries, 16 Mi entries (~64 GiB log), 250k-page read
cache (~1 GiB), cleanup batches of [1000, 10000] entries.

Beyond the paper: the log can be partitioned into ``shards`` independent
sub-logs (cf. "NVMM cache design: Logging vs. Paging" and NVLog's per-core
logs), each with its own commit path, persistent tail and drain thread.
``shard_route`` picks how writes map to shards:

* ``"fdid"``   — strict per-file affinity: shard = fdid % K.  Unrelated
  files never contend on the same fetch-and-add; all writes of one file
  stay totally ordered by one shard's log.
* ``"stripe"`` — per-file *stripe* affinity (the sound version of
  "round-robin for a hot fd"): shard = (fdid + off // stripe_bytes) % K.
  A hot file spreads across every shard, while any two overlapping writes
  still land in the same shard (writes are split at stripe boundaries
  upstream), which keeps per-location ordering a single-log property.

Both routes are *static*: a skewed fdid distribution (several hot files
colliding under ``fdid % K``) collapses back to single-shard throughput.
``shard_rebalance`` layers an epoch-based adaptive router on top
(:mod:`repro.core.router`): per-key load is sampled every
``rebalance_epoch_ms`` and hot fdids (or hot stripes) are migrated to
lighter shards by installing a new routing epoch — each migration takes the
per-file drain barrier first, so the PR-1 invariant (overlapping writes
share a shard log) survives the route change.  ``placement_groups``
partitions the K shards into G NUMA-style groups: a migration never moves a
key out of its group, so a file keeps its shard→drain-thread affinity.
The route table is persisted next to the superblock (``route_base``) so an
attach after a mid-epoch crash routes exactly as before the crash.
``shard_rebalance=False`` (the default, and the paper baseline) leaves the
static routes bit-identical to the PR 3 behavior.

Dual persistence (layout VERSION 4, cf. "NVMM cache design: Logging vs.
Paging"): ``page_frames > 0`` carves a *paged region* out of the NVMM
between the route table and the shard logs.  Each frame holds one
read-cache-page-sized file page as a ping-pong pair of data slots plus a
one-cacheline header (seq / fdid / page / active slot / length / crc), so
an overwrite builds the new page image in the inactive slot and commits it
with a single atomic header flip — in place, with no log append and no
drain replay.  A per-file :class:`StreamClassifier` watches each write
stream (average write size and overwrite ratio over ``classify_window``
writes, the write-side twin of the ``File.ra_next`` readahead detector)
and routes the stream to log or page mode; mode flips take the same
freeze + drain-barrier protocol as route migrations.  ``page_frames=0``
(the default) leaves the layout byte-identical to VERSION 3 modulo the
superblock version/field.
"""
from __future__ import annotations

import dataclasses

KIB = 1024
MIB = 1024 * KIB
GIB = 1024 * MIB

CACHELINE = 64
ENTRY_HEADER = 48
PATH_MAX = 256
FD_MAX = 256
SUPERBLOCK = 4096  # superblock + shard tail table live in the first region
SHARD_TAILS = 64   # per-shard persistent tails start here, one cacheline each
MAX_SHARDS = (SUPERBLOCK - SHARD_TAILS) // CACHELINE
ROUTE_HDR = 16     # persisted route record header (epoch, count, crc)
ROUTE_ENT = 12     # one persisted route override (key u64, sid u32)
FRAME_HDR = 64     # paged-region frame header: one cacheline, so the
#                    commit (header overwrite) is a single-line atomic store


@dataclasses.dataclass(frozen=True)
class Policy:
    """Configuration of one NVCache instance."""

    entry_size: int = 4 * KIB          # fixed-size log entries (paper §II-D)
    log_entries: int = 16 * 1024       # total across shards; paper: 16 Mi
    page_size: int = 4 * KIB           # read-cache page (power of two, §II-C fn2)
    read_cache_pages: int = 1024       # paper: 250k pages (~1 GiB)
    batch_min: int = 1000              # min entries before cleanup batches (§IV-A)
    batch_max: int = 10000             # max entries per cleanup batch
    verify_crc: bool = True            # beyond-paper: per-entry payload CRC32
    fd_max: int = FD_MAX
    path_max: int = PATH_MAX
    shards: int = 1                    # independent sub-logs (1 == paper design)
    shard_route: str = "stripe"        # "stripe" | "fdid" (see module docstring)
    stripe_pages: int = 64             # stripe width, in read-cache pages
    # drain engine (beyond paper; cf. dm-writeboost's coalesced submission):
    drain_coalesce: bool = True        # plan/apply page+extent coalescing;
    #                                    False == the paper's entry-at-a-time
    coalesce_max_extent: int = MIB     # max bytes per coalesced extent write
    fsync_epoch: bool = True           # merge concurrent per-shard fsyncs of
    #                                    the same backend file into epochs
    # batch-spanning coalescing (cf. NVLog keeping its tail extent open
    # across syncs): a drain batch may leave its contiguous tail extent
    # (capped at one page-span of bytes) unconsumed so the next batch's
    # contiguous entries merge into the same backend write.  Deferred
    # entries stay committed in the log with their dirty-page-index refs
    # live, and are force-flushed once they are older than the deadline or
    # whenever a drain barrier (close/flush/fsync) is requested.
    coalesce_span_batches: bool = True  # carry the open tail extent across
    #                                     batches (requires drain_coalesce)
    coalesce_deadline_ms: float = 5.0   # max age of a carried tail extent
    # read path (the read-side twin of the drain engine, paper Fig. 2 miss
    # procedure generalized from one page to one aligned extent): a cache
    # miss loads up to ``readahead_pages`` pages in a single backend
    # operation (``TierFile.preadv``).  1 == the paper's per-page miss.
    # The effective extent is clamped to half the read cache so readahead
    # can never flush the cache it feeds.
    readahead_pages: int = 8
    # adaptive window ramp (kernel-style): a fresh sequential miss stream
    # starts with a 2-page extent and doubles (2 -> 4 -> 8 ...) up to
    # ``readahead_pages`` while the stream stays sequential; any random
    # miss resets the ramp.  Short sequential bursts thus stop paying the
    # full-window device cost.  False == PR-3 behavior (full aligned
    # window on the first sequential miss).
    readahead_ramp: bool = True
    # adaptive shard routing (see module docstring): epoch-based rebalancer
    # migrating hot route keys (fdids, or (fdid, stripe) pairs) to lighter
    # shards.  False == the static routes above, bit-identical to PR 3.
    shard_rebalance: bool = False
    rebalance_epoch_ms: float = 50.0    # load-sampling / rebalance period
    placement_groups: int = 1           # NUMA-style shard groups: migrations
    #                                     stay inside a key's group (1 == any
    #                                     shard is a candidate target)
    route_table_max: int = 64           # max persisted route overrides
    # dual persistence (VERSION 4, see module docstring): paged NVMM region
    # absorbing large / overwrite-heavy streams in place.  0 == log-only,
    # layout-compatible with VERSION 3.
    page_frames: int = 0                # frames in the paged region
    classify_window: int = 32           # writes per classifier window
    page_min_avg_write: int = 0         # avg write size that votes "page";
    #                                     0 == default to page_size
    page_overwrite_ratio: float = 0.5   # overwrite fraction that votes "page"
    page_wb_watermark: float = 0.75     # dirty-frame fraction that wakes the
    #                                     background writeback path
    # stripe-width auto-tuning (router follow-up): a fdid that stays hot for
    # this many consecutive rebalance epochs gets its stripe narrowed (fan-out
    # widened across shards) instead of being re-migrated each epoch.  0
    # disables tuning.
    stripe_tune_streak: int = 3
    stripe_tune_max_shift: int = 4      # stripe never narrows below
    #                                     stripe_bytes >> max_shift (>= page)
    # observability plane (VERSION 5, repro.obs): span-profiler level —
    # 0 == off (a branch per op), 1 == op-level spans + flight commit
    # events, 2 == full per-stage write/read/drain breakdown.
    obs_level: int = 0
    # flight-recorder ring: fixed 64-byte event records carved between the
    # route table and the paged region.  0 == no ring (layout matches
    # VERSION 4 modulo the superblock version/field).
    flight_records: int = 256

    def __post_init__(self):
        if self.obs_level not in (0, 1, 2):
            raise ValueError("obs_level must be 0, 1 or 2")
        if self.flight_records < 0:
            raise ValueError("flight_records must be >= 0")
        if self.page_size & (self.page_size - 1):
            raise ValueError("page_size must be a power of two (radix tree)")
        if self.entry_size <= ENTRY_HEADER:
            raise ValueError(f"entry_size must exceed the {ENTRY_HEADER}-byte header")
        if not 1 <= self.shards <= MAX_SHARDS:
            raise ValueError(f"shards must be in [1, {MAX_SHARDS}]")
        if self.shard_route not in ("stripe", "fdid"):
            raise ValueError("shard_route must be 'stripe' or 'fdid'")
        if self.stripe_pages < 1:
            raise ValueError("stripe_pages must be >= 1")
        if self.coalesce_max_extent < self.page_size:
            raise ValueError("coalesce_max_extent must be >= page_size "
                             "(extents never split a page's merged range)")
        if self.readahead_pages < 1:
            raise ValueError("readahead_pages must be >= 1")
        if self.coalesce_deadline_ms < 0:
            raise ValueError("coalesce_deadline_ms must be >= 0")
        if self.rebalance_epoch_ms <= 0:
            raise ValueError("rebalance_epoch_ms must be > 0")
        if self.route_table_max < 1:
            raise ValueError("route_table_max must be >= 1")
        if self.page_frames < 0:
            raise ValueError("page_frames must be >= 0")
        if self.classify_window < 2:
            raise ValueError("classify_window must be >= 2")
        if not 0.0 < self.page_overwrite_ratio <= 1.0:
            raise ValueError("page_overwrite_ratio must be in (0, 1]")
        if not 0.0 < self.page_wb_watermark <= 1.0:
            raise ValueError("page_wb_watermark must be in (0, 1]")
        if self.stripe_tune_streak < 0:
            raise ValueError("stripe_tune_streak must be >= 0")
        if self.stripe_tune_max_shift < 0:
            raise ValueError("stripe_tune_max_shift must be >= 0")
        if not 1 <= self.placement_groups <= self.shards:
            raise ValueError("placement_groups must be in [1, shards]")
        if self.shards % self.placement_groups:
            raise ValueError("placement_groups must divide shards evenly")
        per = self.log_entries // self.shards
        if per < 2:
            raise ValueError("each shard needs at least 2 entries")
        # normalize: the layout carves equal shards out of the region
        object.__setattr__(self, "log_entries", per * self.shards)
        # a batch larger than a shard can never fill: clamp (paper's config
        # always has batch << log; this guards scaled-down test configs)
        cap = max(1, per // 2)
        if self.batch_min > cap:
            object.__setattr__(self, "batch_min", cap)
        if self.batch_max < self.batch_min:
            object.__setattr__(self, "batch_max", self.batch_min)

    @property
    def entry_data(self) -> int:
        return self.entry_size - ENTRY_HEADER

    @property
    def entries_per_shard(self) -> int:
        return self.log_entries // self.shards

    @property
    def stripe_bytes(self) -> int:
        return self.stripe_pages * self.page_size

    @property
    def fd_table_bytes(self) -> int:
        return self.fd_max * self.path_max

    @property
    def route_base(self) -> int:
        """Persisted route record (epoch + overrides), next to the
        superblock's tables: [superblock | fd table | route table | shards]."""
        return SUPERBLOCK + self.fd_table_bytes

    @property
    def route_table_bytes(self) -> int:
        return ROUTE_HDR + self.route_table_max * ROUTE_ENT

    @property
    def flight_base(self) -> int:
        """Start of the flight-recorder ring (VERSION 5): cacheline-
        aligned, between the route table and the paged region.  Empty
        when ``flight_records == 0``."""
        base = self.route_base + self.route_table_bytes
        return (base + CACHELINE - 1) & ~(CACHELINE - 1)

    @property
    def flight_region_bytes(self) -> int:
        return self.flight_records * CACHELINE

    @property
    def page_base(self) -> int:
        """Start of the paged region (VERSION 4/5): page-aligned, between
        the flight ring and the shard logs.  Empty when
        ``page_frames == 0``."""
        base = self.flight_base + self.flight_region_bytes
        return (base + self.page_size - 1) & ~(self.page_size - 1)

    @property
    def frame_size(self) -> int:
        """One paged frame: header cacheline + two ping-pong data slots."""
        return FRAME_HDR + 2 * self.page_size

    @property
    def page_region_bytes(self) -> int:
        return self.page_frames * self.frame_size

    @property
    def entries_base(self) -> int:
        base = self.page_base + self.page_region_bytes
        return (base + self.page_size - 1) & ~(self.page_size - 1)

    def placement_group(self, sid: int) -> int:
        """NUMA-style group of shard ``sid``: shards are carved into
        ``placement_groups`` equal contiguous runs."""
        return sid // (self.shards // self.placement_groups)

    def static_shard(self, fdid: int, off: int) -> int:
        """The static route formula (see module docstring) — the single
        definition shared by ``NVLog.route`` and the adaptive router's
        fallback."""
        if self.shards == 1:
            return 0
        if self.shard_route == "fdid":
            return fdid % self.shards
        return (fdid + off // self.stripe_bytes) % self.shards

    def frame_base(self, idx: int) -> int:
        return self.page_base + idx * self.frame_size

    @property
    def page_min_avg(self) -> int:
        """Effective classifier size threshold (0 defaults to page_size)."""
        return self.page_min_avg_write or self.page_size

    def shard_base(self, sid: int) -> int:
        return self.entries_base + sid * self.entries_per_shard * self.entry_size

    def shard_tail_off(self, sid: int) -> int:
        return SHARD_TAILS + sid * CACHELINE

    @property
    def nvmm_bytes(self) -> int:
        return self.entries_base + self.log_entries * self.entry_size


#: Paper §IV-A configuration (64 GiB log, 1 GiB read cache), with the
#: paper's propagation path: entry-at-a-time draining behind the kernel
#: page cache, no user-space coalescing or fsync-epoch merging — the
#: faithful-reproduction baseline the beyond-paper engine is measured
#: against (benchmarks/fig8_coalescing.py).
PAPER_DEFAULT = Policy(
    entry_size=4 * KIB,
    log_entries=16 * 1024 * 1024,
    read_cache_pages=250_000,
    batch_min=1000,
    batch_max=10000,
    drain_coalesce=False,
    fsync_epoch=False,
    coalesce_span_batches=False,
    readahead_pages=1,
    readahead_ramp=False,
)

class StreamClassifier:
    """Per-file write-stream classifier for the dual persistence engine.

    The write-side twin of the ``File.ra_next`` readahead detector: instead
    of watching miss offsets it watches write sizes and page reuse.  Every
    ``classify_window`` writes it closes a window and votes:

    * ``"page"`` if the window's average write size reaches
      ``page_min_avg`` (large streams — the log's double copy dominates), or
      if at least ``page_overwrite_ratio`` of the window's bytes landed on
      pages already written recently *and* writes are at least half a page
      (rewrite-heavy streams — in-place frames absorb the churn);
    * ``"log"`` otherwise (small synchronous writes — append wins).

    A mode switch needs two consecutive windows voting the same way
    (hysteresis), so a flip-flop stream that alternates window by window
    never migrates.  The classifier only *proposes*: :meth:`note_write`
    returns the new mode when a switch is confirmed and the caller flips
    ``mode`` once the migration actually lands (a failed freeze leaves the
    proposal standing, so it fires again next window).
    """

    __slots__ = ("page_size", "window", "min_avg", "ow_ratio",
                 "mode", "_vote", "_count", "_bytes", "_ow_bytes",
                 "_pages", "_prev_pages", "stats_windows", "stats_switches")

    _PAGES_CAP = 8192  # bound the recent-page sets for huge streams

    def __init__(self, policy: Policy):
        self.page_size = policy.page_size
        self.window = policy.classify_window
        self.min_avg = policy.page_min_avg
        self.ow_ratio = policy.page_overwrite_ratio
        self.mode = "log"
        self._vote = None        # last window's vote, for hysteresis
        self._count = 0
        self._bytes = 0
        self._ow_bytes = 0
        self._pages = set()      # pages written in the open window
        self._prev_pages = set() # pages written in the previous window
        self.stats_windows = 0
        self.stats_switches = 0

    def note_write(self, off: int, n: int):
        """Record one write; returns ``"log"``/``"page"`` when a confirmed
        mode switch is proposed, else ``None``."""
        if n <= 0:
            return None
        ps = self.page_size
        p0, p1 = off // ps, (off + n - 1) // ps
        for p in range(p0, p1 + 1):
            if p in self._pages or p in self._prev_pages:
                s = max(off, p * ps)
                e = min(off + n, (p + 1) * ps)
                self._ow_bytes += e - s
            elif len(self._pages) < self._PAGES_CAP:
                self._pages.add(p)
        self._count += 1
        self._bytes += n
        if self._count < self.window:
            return None
        return self._close_window()

    def _close_window(self):
        avg = self._bytes / self._count
        ow = self._ow_bytes / self._bytes if self._bytes else 0.0
        want = ("page" if avg >= self.min_avg
                or (ow >= self.ow_ratio and 2 * avg >= self.min_avg)
                else "log")
        prev_vote = self._vote
        self._vote = want
        self._prev_pages = self._pages
        self._pages = set()
        self._count = self._bytes = self._ow_bytes = 0
        self.stats_windows += 1
        if want != self.mode and prev_vote == want:
            self.stats_switches += 1
            return want
        return None

    def confirm(self, mode: str) -> None:
        """The caller completed the migration; the stream is now ``mode``."""
        self.mode = mode


#: Small configuration for unit/property tests.
TEST_SMALL = Policy(
    entry_size=256,
    log_entries=64,
    page_size=256,
    read_cache_pages=8,
    batch_min=4,
    batch_max=16,
)
