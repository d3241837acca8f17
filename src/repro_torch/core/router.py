"""Epoch-based adaptive shard router (load-aware rebalancing on top of the
static routes of :mod:`repro.core.policy`).

The static routes are the PR-1 contract: ``fdid % K`` or per-stripe
``(fdid + off // stripe_bytes) % K``.  Both can collapse under skew — two
hot SQLite/RocksDB files whose fdids collide modulo K serialize on one
shard's fetch-and-add and drain thread, which is exactly the per-core-log
contention problem "NVMM cache design: Logging vs. Paging" identifies.
This module makes the route *adaptive* without giving up the invariant the
whole sharded design rests on.

Routing model
-------------
A **route key** is the unit of migration: the fdid in ``"fdid"`` mode, the
``(fdid, stripe)`` pair in ``"stripe"`` mode (packed into one u64).  The
router holds an immutable override table ``{key: sid}`` plus a monotonically
increasing **epoch**; a key without an override routes by the static
formula, so an empty table is bit-identical to the static router.  Installing
a new epoch swaps the whole table atomically (one reference store), so a
writer observes either the old or the new route, never a mix.

Why migration requires the drain barrier (the ordering proof)
-------------------------------------------------------------
Correctness of sharding rests on one invariant: **any two overlapping
writes append to the same shard log**.  Within one shard, allocation order
equals global-``seq`` order (the seq is drawn inside the shard's allocation
lock), so the drain applies same-page writes in commit order and a
dirty-miss replay sees them in ``seq`` order; across shards nothing orders
two drain threads.  A migration of key X from shard *a* to shard *b*
threatens the invariant in exactly one way: an old write W1 to X still
*live in shard a* (committed but not yet drained) while a new write W2 to
the same location appends to shard b.  Then shard a's and shard b's drain
threads race, and the backend can end up with W1's stale bytes over W2's.

The migration protocol therefore is, per key:

1. **freeze** the owning file's route gate — new writes to the file block,
   and the rebalancer waits until in-flight writes (which pinned the old
   epoch when they looked up their route) have committed;
2. run the per-file **drain barrier** (``api._drain_barrier``, the same
   barrier close/flock/O_TRUNC use): every committed entry of the file is
   written to the backend, fsynced, and retired from the log;
3. **install** the new epoch (override X -> b) and persist it;
4. unfreeze — blocked writers re-run their route lookup under the new
   table.

After step 2 the old shard holds *no* live entry for the file, so when the
first post-migration write appends to shard b there is nothing left in
shard a it could overlap with: every pair of overlapping live writes is
again same-shard, and the invariant holds in every epoch.  Recovery needs
no extra machinery — its cross-shard merge replays committed groups in
ascending global ``seq``, which is a superset of the per-shard ordering the
invariant guarantees, so a crash *between* any two protocol steps replays
in commit order regardless of which epoch the table shows.  The epoch
record is still persisted next to the superblock (CRC-guarded, written
payload-then-header with pwb/pfence/psync) so an attach after a mid-epoch
crash — e.g. ``NVLog(format=False)`` on a region with live entries — routes
new writes exactly as the pre-crash instance did, instead of silently
falling back to the static route while old-epoch entries are still live.

Load model
----------
``EpochRouter.note_append`` counts entries appended per route key;
:class:`repro.core.cleanup.CleanupPool`'s rebalance thread closes an epoch
every ``Policy.rebalance_epoch_ms``, samples per-shard load —
entries appended (from the key counters), drain queue depth and allocation
wait time (:meth:`repro.core.log.LogShard.load_sample`) — and asks
:meth:`EpochRouter.plan` for migrations.  The planner is greedy with
hysteresis: within each placement group it moves the hottest movable keys
from the most- to the least-loaded shard, only while the imbalance ratio
exceeds ``MIN_RATIO`` and each move strictly improves the spread, and never
more than ``MAX_MIGRATIONS_PER_EPOCH`` per group per epoch (each migration
costs a per-file drain barrier, so convergence is rate-limited by design).

Stripe-width auto-tuning (the rebalancing follow-up): a fdid the planner
wants to migrate ``Policy.stripe_tune_streak`` epochs in a row is
*persistently* hot — per-stripe moves are chasing it without converging.
Instead of another migration, :meth:`EpochRouter.plan` emits a width
change (``Migration.new_shift``): the fdid's stripe is halved, doubling
its fan-out across shards via the static formula, and every per-stripe
override it owned is dropped in the same epoch.  The install rides the
same freeze + drain-barrier protocol, so the re-keying can never strand a
live entry, and the per-fdid shifts are persisted in the route record
(flag-tagged entries) so an attach routes with the tuned width.
"""
from __future__ import annotations

import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core import locking
from repro_torch.core.nvmm import NVMM
from repro_torch.core.policy import Policy, ROUTE_ENT, ROUTE_HDR

_RT_HDR = struct.Struct("<QII")    # epoch, count, crc(payload || epoch || count)
_RT_ENT = struct.Struct("<QI")     # key, sid
assert _RT_HDR.size == ROUTE_HDR
assert _RT_ENT.size == ROUTE_ENT

# stripe-mode keys pack (fdid, stripe) into one u64; stripes beyond the
# 40-bit field (≈ petabyte offsets at default stripe width) stay static
_STRIPE_BITS = 40
_STRIPE_MASK = (1 << _STRIPE_BITS) - 1

# persisted stripe-width tuning entries share the route record: a record
# entry whose key has this flag set maps fdid -> stripe shift, not key ->
# sid.  Real route keys never reach bit 63 (fdid < fd_max << 40).
_WIDTH_FLAG = 1 << 63

MIN_RATIO = 1.5                # hot/cold load ratio needed before migrating
MIN_EPOCH_ENTRIES = 16         # ignore epochs with almost no traffic
MAX_MIGRATIONS_PER_EPOCH = 2   # per placement group (each costs a barrier)
QUEUE_WEIGHT = 0.5             # drain-backlog penalty when picking a TARGET
#                                shard (a backlogged shard is a bad home for
#                                a hot key).  The migrate/stay decision uses
#                                appended entries only: backlog is backward-
#                                looking and largely belongs to the very key
#                                being considered, so counting it would
#                                justify moves that merely relocate the hot
#                                spot and ping-pong every epoch.
MIN_IMPROVEMENT = 0.05         # a move must lower the hot shard's load by
#                                >= 5% (max(hot-n, cold+n) <= 0.95*hot) —
#                                otherwise it merely relocates the hot spot
#                                (and a noise key is not worth a barrier)
BARRIER_HORIZON_EPOCHS = 32    # migration cost model: a move's drain
#                                barrier stalls the frozen file until its
#                                pending entries land — estimated as the
#                                hot shard's queue depth scaled by the
#                                key's share of the shard's load (the
#                                barrier waits on the FILE's entries, not
#                                the whole shard).  The move pays off if
#                                the per-epoch load reduction, recouped
#                                over this many epochs (~a second of
#                                steady traffic — hysteresis already
#                                stops churn), exceeds that one-time
#                                cost; a key whose backlog (in entries ≈
#                                bytes / entry_size) outweighs it is
#                                skipped and counted in
#                                ``stats_skipped_uneconomic``.


class Migration:
    """One planned route change: move ``key`` (owned by ``fdid``) from
    shard ``old_sid`` to ``new_sid``."""

    __slots__ = ("key", "fdid", "old_sid", "new_sid", "load", "new_shift")

    def __init__(self, key: int, fdid: int, old_sid: int, new_sid: int,
                 load: int, new_shift: Optional[int] = None):
        self.key = key
        self.fdid = fdid
        self.old_sid = old_sid
        self.new_sid = new_sid
        self.load = load
        # stripe-width tuning: when set, this "migration" narrows the
        # fdid's stripe to stripe_bytes >> new_shift (widening its fan-out
        # across shards) instead of moving one key — same freeze + drain
        # barrier, different install
        self.new_shift = new_shift

    def __repr__(self) -> str:
        if self.new_shift is not None:
            return (f"Migration(fdid={self.fdid}, widen->shift="
                    f"{self.new_shift}, load={self.load})")
        return (f"Migration(key={self.key:#x}, fdid={self.fdid}, "
                f"{self.old_sid}->{self.new_sid}, load={self.load})")


class EpochRouter:
    """The adaptive route table: static formula + epoch-versioned overrides.

    Thread model: ``route`` is lock-free (it reads one immutable dict
    reference — writers may call it concurrently with an install and see
    either epoch, which the freeze/barrier protocol makes safe);
    ``note_append`` takes a short counter lock; ``install``/``plan`` are
    serialized by the rebalance thread (plus ``_lock`` for safety).
    """

    GUARDED_BY = {
        # immutable-swap tables: installs rebind a fresh dict under _lock,
        # lookups read the reference lock-free and see one epoch or the next
        "epoch": "write:_lock", "table": "write:_lock",
        "stripe_shift": "write:_lock",
        "_key_load": "_lock", "_key_fdid": "_lock", "_streak": "_lock",
        "stats_migrations": "_lock", "stats_epochs": "_lock",
        "stats_installs": "_lock", "stats_skew_ratio": "_lock",
        "stats_skipped_uneconomic": "_lock", "stats_stripe_widenings": "_lock",
    }

    def __init__(self, nvmm: NVMM, policy: Policy, *, sampling: bool = True):
        """``sampling=False`` builds a route-only router (used by
        ``NVLog``'s attach auto-adoption, where no rebalance thread exists
        to drain the per-key counters): lookups honor the persisted table
        but ``note_append`` is a no-op, so the counters cannot leak."""
        self.nvmm = nvmm
        self.policy = policy
        self.sampling = sampling
        self._lock = locking.make_lock("leaf:router")  # installs + counters
        self.epoch = 0                         # guarded-by: write:_lock
        self.table: Dict[int, int] = {}        # key -> sid (immutable; swapped)
        #                                        guarded-by: write:_lock
        self._key_load: Dict[int, int] = {}    # entries appended this epoch
        self._key_fdid: Dict[int, int] = {}    # key -> owning fdid
        #                                        (both guarded-by: _lock)
        # guarded-by: _lock — planner/installer counters; api.stats()
        # reads them through snapshot_stats()
        self.stats_migrations = 0
        self.stats_epochs = 0                  # rebalance ticks evaluated
        self.stats_installs = 0                # epochs actually installed
        self.stats_skew_ratio = 0.0            # last epoch's hot/cold ratio
        self.stats_skipped_uneconomic = 0      # moves rejected by the cost
        #                                        model (barrier > gain)
        self.stats_stripe_widenings = 0        # width-tuning installs
        self._streak: Dict[int, int] = {}      # fdid -> consecutive epochs
        #                                        the planner wanted to move
        #                                        it; guarded-by: _lock
        #                                        (drop_fdid pops from api
        #                                        threads while the planner
        #                                        rebinds it)
        epoch, table, shifts = load_route_record(nvmm, policy)
        self.epoch = epoch
        self.table = table
        self.stripe_shift: Dict[int, int] = shifts  # fdid -> width shift
        #   (immutable like ``table``: installs swap a fresh dict;
        #   guarded-by: write:_lock)

    # ---------------------------------------------------------------- route
    def stripe_bytes_of(self, fdid: int) -> int:
        """Effective stripe width of ``fdid`` (auto-tuning may have narrowed
        it below ``policy.stripe_bytes`` to widen the file's shard fan-out)."""
        return self.policy.stripe_bytes >> self.stripe_shift.get(fdid, 0)

    def key_of(self, fdid: int, off: int) -> Optional[int]:
        if self.policy.shard_route == "fdid":
            return fdid
        stripe = off // self.stripe_bytes_of(fdid)
        if stripe > _STRIPE_MASK:
            return None
        return (fdid << _STRIPE_BITS) | stripe

    @staticmethod
    def key_fdid(key: int, policy: Policy) -> int:
        return key if policy.shard_route == "fdid" else key >> _STRIPE_BITS

    def key_off(self, key: int) -> int:
        """A file offset inside the key's stripe (0 in fdid mode) —
        enough to reconstruct the static route of the key."""
        if self.policy.shard_route == "stripe":
            fdid = key >> _STRIPE_BITS
            return (key & _STRIPE_MASK) * self.stripe_bytes_of(fdid)
        return 0

    def static_route(self, fdid: int, off: int) -> int:
        sh = self.stripe_shift.get(fdid)
        if sh and self.policy.shard_route == "stripe" \
                and self.policy.shards > 1:
            return (fdid + off // (self.policy.stripe_bytes >> sh)) \
                % self.policy.shards
        return self.policy.static_shard(fdid, off)

    def static_sid_of_key(self, key: int) -> int:
        return self.static_route(self.key_fdid(key, self.policy),
                                 self.key_off(key))

    def current_sid(self, key: int) -> int:
        sid = self.table.get(key)
        return sid if sid is not None else self.static_sid_of_key(key)

    def route(self, fdid: int, off: int) -> int:
        key = self.key_of(fdid, off)
        if key is not None:
            sid = self.table.get(key)          # immutable dict: atomic read
            if sid is not None:
                return sid
        return self.static_route(fdid, off)

    # ------------------------------------------------------------- sampling
    def note_append(self, fdid: int, off: int, k_entries: int) -> None:
        if not self.sampling:
            return                             # route-only router: nobody
            #                                    ever drains the counters
        key = self.key_of(fdid, off)
        if key is None:
            return
        with self._lock:
            self._key_load[key] = self._key_load.get(key, 0) + k_entries
            self._key_fdid[key] = fdid

    def shard_loads(self, key_load: Dict[int, int]) -> List[float]:
        """Per-shard load of one epoch: entries appended, by current route."""
        loads = [0.0] * self.policy.shards
        for key, n in key_load.items():
            loads[self.current_sid(key)] += n
        return loads

    # ------------------------------------------------------------- planning
    def plan(self, queue_depths: Optional[List[int]] = None,
             wait_deltas: Optional[List[float]] = None) -> List[Migration]:
        """Close the current sampling epoch and return the migrations to
        perform (possibly empty).  The caller executes each migration under
        the freeze + drain-barrier protocol and then calls :meth:`install`.

        Decision inputs: per-key appended entries drive the hot/cold
        split; ``queue_depths`` (drain backlog) penalizes target shards;
        ``wait_deltas`` (alloc-wait seconds this epoch) breaks ties for
        the hot shard — of two equally-loaded shards, the one writers
        actually stalled on is the one worth relieving.

        Holds ``_lock`` end to end: the planner mutates the epoch counters
        and the migration streaks, which ``drop_fdid`` (api threads) also
        touches.  Pure CPU, once per epoch — writers only contend on their
        short ``note_append`` during the planning instant.
        """
        with self._lock:
            return self._plan_locked(queue_depths, wait_deltas)

    def _plan_locked(self, queue_depths: Optional[List[int]],
                     wait_deltas: Optional[List[float]]) -> List[Migration]:
        key_load = self._key_load
        key_fdid = self._key_fdid
        self._key_load = {}
        self._key_fdid = {}
        self.stats_epochs += 1
        k = self.policy.shards
        if k == 1 or sum(key_load.values()) < MIN_EPOCH_ENTRIES:
            return []
        loads = self.shard_loads(key_load)
        queues = queue_depths if queue_depths is not None else [0] * k
        waits = wait_deltas if wait_deltas is not None else [0.0] * k
        key_sid = {key: self.current_sid(key) for key in key_load}
        # migrations that will need a NEW table slot must fit: planning a
        # move install() will refuse just burns a freeze + drain barrier
        # on the hot file, every epoch, forever
        free_slots = self.policy.route_table_max - len(self.table) \
            - len(self.stripe_shift)
        out: List[Migration] = []
        for g in range(self.policy.placement_groups):
            group = [s for s in range(k)
                     if self.policy.placement_group(s) == g]
            if len(group) < 2:
                continue
            for _ in range(MAX_MIGRATIONS_PER_EPOCH):
                hot = max(group, key=lambda s: (loads[s], waits[s]))
                # target choice penalizes drain backlog: a shard still
                # churning through old entries is a bad home for a hot key
                cold = min(group,
                           key=lambda s: loads[s] + QUEUE_WEIGHT * queues[s])
                self.stats_skew_ratio = loads[hot] / max(1.0, loads[cold])
                if hot == cold or loads[hot] < MIN_RATIO * max(1.0, loads[cold]):
                    break
                # hottest key on the hot shard whose move meaningfully
                # lowers the group's maximum (not merely relocates it),
                # preferring the largest such key.  The cost model then
                # vetoes moves whose drain barrier — flushing the hot
                # shard's whole backlog before the epoch can flip — costs
                # more entries than the move recoups over the horizon.
                cap = (1.0 - MIN_IMPROVEMENT) * loads[hot]
                best = best_any = None
                for key, n in key_load.items():
                    if key_sid[key] != hot or n <= 0:
                        continue
                    if (key not in self.table and free_slots <= 0
                            and cold != self.static_sid_of_key(key)):
                        continue               # would not fit the table
                    if max(loads[hot] - n, loads[cold] + n) <= cap:
                        if best_any is None or n > key_load[best_any]:
                            best_any = key
                        gain = loads[hot] - max(loads[hot] - n,
                                                loads[cold] + n)
                        barrier_cost = queues[hot] * n / max(1.0, loads[hot])
                        if barrier_cost > BARRIER_HORIZON_EPOCHS * gain:
                            continue           # barrier outweighs the gain
                        if best is None or n > key_load[best]:
                            best = key
                if best is None:
                    if best_any is not None:
                        # a move was justified by imbalance but vetoed by
                        # the cost model: surface it, don't pay the barrier
                        self.stats_skipped_uneconomic += 1
                    break
                if best not in self.table \
                        and cold != self.static_sid_of_key(best):
                    free_slots -= 1
                out.append(Migration(best, key_fdid[best], hot, cold,
                                     key_load[best]))
                loads[hot] -= key_load[best]
                loads[cold] += key_load[best]
                key_sid[best] = cold
        return self._tune_widths_locked(out)

    def _tune_widths_locked(self, out: List[Migration]) -> List[Migration]:
        """Stripe-width auto-tuning: a fdid the planner keeps wanting to
        migrate — ``stripe_tune_streak`` consecutive epochs — is hot enough
        that chasing individual stripes (at most ``MAX_MIGRATIONS_PER_EPOCH``
        per epoch, a drain barrier each) never converges.  Replace its
        per-key moves with ONE width change: halving the fdid's stripe
        doubles its shard fan-out, spreading the load by the static formula
        with no per-stripe overrides at all."""
        pol = self.policy
        if pol.shard_route != "stripe" or pol.stripe_tune_streak <= 0 \
                or pol.shards == 1:
            return out
        moved = {m.fdid for m in out}
        # a miss resets the streak: "persistently hot" means consecutive
        self._streak = {f: self._streak.get(f, 0) + 1 for f in moved}
        widened = set()
        tuned: List[Migration] = []
        for fdid in sorted(moved):
            shift = self.stripe_shift.get(fdid, 0)
            if (self._streak.get(fdid, 0) < pol.stripe_tune_streak
                    or shift >= pol.stripe_tune_max_shift
                    or pol.stripe_bytes >> (shift + 1) < pol.page_size
                    # the narrowed stripe must stay page-aligned: a page
                    # spanning two stripes would break the overlap
                    # invariant (and the paged mode's per-page fallback)
                    or (pol.stripe_bytes >> (shift + 1)) % pol.page_size):
                continue
            load = sum(m.load for m in out if m.fdid == fdid)
            tuned.append(Migration(0, fdid, -1, -1, load,
                                   new_shift=shift + 1))
            widened.add(fdid)
            self._streak.pop(fdid, None)
        if not widened:
            return out
        return [m for m in out if m.fdid not in widened] + tuned

    # -------------------------------------------------------------- install
    def install(self, key: int, sid: int) -> bool:
        """Publish a new routing epoch with ``key -> sid`` and persist it.
        Returns False (no epoch change) when the persisted table is full
        even after dropping no-op overrides."""
        with self._lock:
            table = dict(self.table)
            if self.static_sid_of_key(key) == sid:
                table.pop(key, None)           # back to static: drop override
            else:
                table[key] = sid
            cap = self.policy.route_table_max - len(self.stripe_shift)
            if len(table) > cap:
                # drop overrides that merely restate the static route
                for ikey in list(table):
                    if table[ikey] == self.static_sid_of_key(ikey):
                        del table[ikey]
                if len(table) > cap:
                    return False
            self.epoch += 1
            self.table = table                 # atomic publish
            self._persist_locked()
            self.stats_installs += 1
            return True

    def install_width(self, fdid: int, shift: int) -> bool:
        """Publish a stripe-width change for ``fdid`` and persist it.  The
        fdid's per-key overrides are dropped in the same epoch — their
        stripe indices are in old-width units.  The caller holds the file's
        freeze + drain barrier, so no shard holds a live entry routed under
        the old width: the first post-install write can't overlap anything
        the old routing placed elsewhere (same argument as a migration)."""
        pol = self.policy
        if pol.shard_route != "stripe":
            return False
        with self._lock:
            table = {k: s for k, s in self.table.items()
                     if self.key_fdid(k, pol) != fdid}
            shifts = dict(self.stripe_shift)
            if shift <= 0:
                shifts.pop(fdid, None)
            else:
                shifts[fdid] = shift
            if len(table) + len(shifts) > pol.route_table_max:
                return False
            self.epoch += 1
            self.table = table                 # atomic publish (route first:
            self.stripe_shift = shifts         # stale key lookups just miss)
            self._persist_locked()
            self.stats_installs += 1
            self.stats_stripe_widenings += 1
            return True

    def drop_fdid(self, fdid: int) -> bool:
        """Remove (and persist) every override owned by ``fdid`` — called
        when the file table retires the fdid.  The file is fully drained at
        that point (retire requires pending <= 0), so reverting its keys to
        the static route cannot strand live entries; NOT dropping them
        would let dead overrides accumulate until the persisted table hits
        ``route_table_max`` and every future migration fails after paying
        its drain barrier.  Also keeps a reused fdid from inheriting the
        dead file's routing."""
        with self._lock:
            table = {k: s for k, s in self.table.items()
                     if self.key_fdid(k, self.policy) != fdid}
            shifts = {f: s for f, s in self.stripe_shift.items()
                      if f != fdid}
            if len(table) == len(self.table) \
                    and len(shifts) == len(self.stripe_shift):
                return False
            self.epoch += 1
            self.table = table
            self.stripe_shift = shifts
            self._streak.pop(fdid, None)
            self._persist_locked()
            return True

    def _persist_locked(self) -> None:
        """Durably record (epoch, overrides): payload first, pwb+pfence,
        then the CRC'd header, pwb+psync — a crash mid-install leaves either
        the old record or the new one, never a half-record that parses (the
        CRC covers payload + epoch + count)."""
        pol = self.policy
        entries = sorted(self.table.items())
        entries += [(_WIDTH_FLAG | fdid, shift)
                    for fdid, shift in sorted(self.stripe_shift.items())]
        payload = b"".join(_RT_ENT.pack(key, val) for key, val in entries)
        base = pol.route_base
        if payload:
            self.nvmm.store(base + ROUTE_HDR, payload)
            self.nvmm.pwb(base + ROUTE_HDR, len(payload))
            self.nvmm.pfence()
        crc = zlib.crc32(payload + struct.pack("<QI", self.epoch,
                                               len(entries)))
        self.nvmm.store(base, _RT_HDR.pack(self.epoch, len(entries), crc))
        self.nvmm.pwb(base, ROUTE_HDR)
        self.nvmm.psync()

    def snapshot_stats(self) -> Dict[str, float]:
        """Coherent copy of the planner/installer counters for api.stats()
        (they are mutated under ``_lock`` by the rebalance thread)."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "overrides": len(self.table),
                "epochs": self.stats_epochs,
                "installs": self.stats_installs,
                "skew_ratio": self.stats_skew_ratio,
                "skipped_uneconomic": self.stats_skipped_uneconomic,
                "stripe_widenings": self.stats_stripe_widenings,
                "stripe_shifts": len(self.stripe_shift),
            }


def load_route_record(nvmm: NVMM, policy: Policy
                      ) -> Tuple[int, Dict[int, int], Dict[int, int]]:
    """Read the persisted route record as ``(epoch, table, stripe_shifts)``;
    ``(0, {}, {})`` when absent or torn (CRC mismatch — e.g. a crash
    mid-install before the header landed).  Recovery also calls this to
    report the epoch it recovered across."""
    base = policy.route_base
    epoch, count, crc = _RT_HDR.unpack_from(nvmm.load(base, ROUTE_HDR))
    if epoch == 0 and count == 0 and crc == 0:
        return 0, {}, {}
    if count > policy.route_table_max:
        return 0, {}, {}
    payload = bytes(nvmm.load(base + ROUTE_HDR, count * ROUTE_ENT))
    if zlib.crc32(payload + struct.pack("<QI", epoch, count)) != crc:
        return 0, {}, {}
    table: Dict[int, int] = {}
    shifts: Dict[int, int] = {}
    for i in range(count):
        key, val = _RT_ENT.unpack_from(payload, i * ROUTE_ENT)
        if key & _WIDTH_FLAG:
            shifts[key & ~_WIDTH_FLAG] = val
        elif val < policy.shards:
            table[key] = val
    return epoch, table, shifts
