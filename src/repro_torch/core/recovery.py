"""Recovery procedure (paper §III "Recovery procedure"), sharded.

On restart after a crash: re-open the files listed in the NVMM fd-path
table, scan *each shard* independently for committed entry groups starting
at that shard's persistent tail (uncommitted holes are skipped — possible
because entries are fixed-size, paper §II-D), then **merge the groups of
all shards by their global commit sequence number** and replay them in that
order, ``sync`` the backends, empty the log and clear the table.

The seq-merge is what preserves durable linearizability across shards: any
two overlapping writes were routed to the same shard (so their seqs are
ordered by that shard's log), and replaying the union in ascending seq
therefore applies every file location's writes in commit order.  Adaptive
routing (:mod:`repro.core.router`) changes nothing here: a migration drains
the old shard before the new epoch takes effect, so the union of committed
groups is still totally ordered per file location by ``seq`` — the merge
replays correctly across a mid-epoch crash, whichever epoch the persisted
route record shows (``RecoveryStats.route_epoch`` reports it).

Failure semantics of the replay itself:

* **Torn groups are dropped whole.**  A multi-entry ``pwrite`` is one
  commit group; if ANY entry of a group fails its CRC (or a committed head
  is missing followers), replaying the surviving entries would surface a
  partially applied write — exactly the tearing the commit protocol exists
  to rule out.  The whole group is skipped and counted in
  ``RecoveryStats.groups_dropped``.
* **A failing backend never leaks handles or half-promises durability.**
  If ``open_backend``/``pwrite`` raises mid-replay, every opened handle is
  closed, only files whose groups ALL replayed are fsynced, the log is NOT
  reformatted (the exception propagates and ``recover`` can be retried —
  replay is idempotent), and the original exception is re-raised.
* **Namespace records replay seq-merged with the data groups**
  (:mod:`repro.core.namespace`): a create/rename/unlink/ftruncate entry is
  applied to the backend namespace at its position in the global seq
  order, so data written before a rename is attributed to the renamed
  file, an unlinked file's bytes never resurrect (the op's drain barrier
  put every covered data entry below its seq), and a re-created path
  starts fresh.  Each replay is idempotent; a torn record is dropped whole
  like any torn group (the namespace is old-or-new, never torn).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.log import (CG_HEAD, META_FDID, META_NO_FDID, MOP_CREATE,
                            MOP_FTRUNCATE, MOP_RENAME, MOP_UNLINK, Entry,
                            NVLog, decode_meta)
from repro_torch.core.nvmm import NVMM
from repro_torch.core.policy import Policy
from repro_torch.core.router import load_route_record


@dataclasses.dataclass
class RecoveryStats:
    entries_replayed: int = 0
    bytes_replayed: int = 0
    holes_skipped: int = 0
    crc_failures: int = 0
    groups_dropped: int = 0      # torn groups skipped in full (never partial)
    files: int = 0
    shards: int = 1
    groups_merged: int = 0
    route_epoch: int = 0         # routing epoch persisted at crash time
    meta_ops: int = 0            # namespace records replayed (seq-merged)
    meta_skipped: int = 0        # records at/below the backend's applied
    #                              watermark (already reflected in it)
    unlinked_dropped: int = 0    # data groups of an unlinked fdid committed
    #                              after its unlink (POSIX: they died with
    #                              the name — replaying them would re-create
    #                              the dead path around a racing writer)
    frames_seen: int = 0         # mapped paged-region frames found (v4)
    frames_replayed: int = 0     # frames whose image reached the backend
    frames_dropped: int = 0      # frames failing CRC (dropped whole)
    # forensic timeline (v5): the flight-recorder events that survived the
    # crash, ordered by event seq (repro.obs.flight.FlightEvent), plus the
    # count of torn records the decoder dropped.  Decoded before replay —
    # the closing reformat wipes the ring.
    flight_events: List = dataclasses.field(default_factory=list)
    flight_torn_dropped: int = 0


def recover(nvmm: NVMM, policy: Policy,
            backend) -> RecoveryStats:
    """Replay the log into the slow tier and reset the region.

    ``backend`` is either a tier-like object (``open(path)`` plus the
    namespace surface ``exists``/``unlink``/``rename`` used to replay
    metadata records) or a bare ``open_backend(path)`` callable — the
    historic signature, still accepted; a bound ``Tier.open`` exposes its
    tier through ``__self__``, and a region with no namespace records
    never needs more than ``open``.
    """
    if hasattr(backend, "open"):
        tier, open_backend = backend, backend.open
    else:
        open_backend = backend
        owner = getattr(backend, "__self__", None)
        tier = owner if hasattr(owner, "unlink") else None
    log = NVLog(nvmm, policy, format=False, adopt=False)
    stats = RecoveryStats(shards=policy.shards)
    stats.route_epoch, _, _ = load_route_record(nvmm, policy)

    # phase 0 (layout v5): decode the flight-recorder ring FIRST — the
    # closing reformat zeroes everything below entries_base, ring
    # included.  The surviving timeline is pure forensics (never consulted
    # by the replay): what the engine was doing when the power died.
    if policy.flight_records:
        from repro_torch.obs.flight import decode_ring
        stats.flight_events, stats.flight_torn_dropped = \
            decode_ring(nvmm, policy)

    # phase 1: scan each shard independently, collecting committed groups
    # (head entry + its committed followers) in shard-log order.
    groups: List[tuple[int, int, List[Entry]]] = []   # (seq, sid, entries)
    seen = 0
    for sh in log.shards:
        ptail = sh.persistent_tail
        cur: List[Entry] | None = None
        for e in sh.scan_committed(ptail, ptail + sh.n):
            seen += 1
            if e.cg == CG_HEAD:
                cur = [e]
                groups.append((e.seq, sh.sid, cur))
            elif cur is not None:
                cur.append(e)
    total = log.n * policy.shards
    stats.holes_skipped = total - seen if seen <= total else 0

    # phase 1b (layout v4): fold each mapped paged-region frame into the
    # merge as a synthetic one-entry group at the frame's commit seq.  The
    # frame protocol (core/pager.py) guarantees the active slot is a whole
    # committed page image, so it flows through the same machinery as a
    # log group: CRC validation, the dead-fdid barrier, the orphan drop
    # for retired fd-table slots, and seq ordering against metadata ops —
    # a frame overwritten before a journaled ftruncate replays before the
    # cut, one committed after it replays after.  ``sid=policy.shards``
    # (one past the last real shard) keeps the sort key well-defined.
    if policy.page_frames:
        from repro_torch.core.pager import scan_frames
        ps = policy.page_size
        for fr in scan_frames(nvmm, policy):
            stats.frames_seen += 1
            groups.append((fr.seq, policy.shards,
                           [Entry(policy.shards, fr.idx, CG_HEAD, fr.seq,
                                  fr.page_no * ps, fr.fdid, fr.length, 0,
                                  fr.crc, fr.data)]))

    # phase 2: merge by global commit sequence; validate whole groups.  A
    # group is all-or-nothing: one bad CRC (or a missing follower) drops the
    # entire group, never just the failing entry — a multi-entry pwrite must
    # not resurface partially applied.
    groups.sort(key=lambda g: (g[0], g[1]))
    stats.groups_merged = len(groups)
    valid: List[tuple[int, int, List[Entry]]] = []
    for seq, sid, entries in groups:
        bad = sum(1 for e in entries if not log.verify_entry(e))
        stats.crc_failures += bad
        if bad or len(entries) != 1 + entries[0].nfollow:
            stats.groups_dropped += 1
            if sid == policy.shards:
                stats.frames_dropped += 1
            continue
        if entries[0].fdid == META_FDID:
            try:   # a namespace record must also parse; torn == dropped whole
                decode_meta(b"".join(bytes(e.data) for e in entries))
            except ValueError:
                stats.groups_dropped += 1
                continue
        valid.append((seq, sid, entries))

    # phase 3: replay in merge order.  Namespace records replay seq-merged
    # with the data groups — the merge is what rebuilds the namespace
    # old-or-new: data written before a rename lands under the old binding
    # that the rename then moves, an unlink deletes everything below its
    # seq, and a later re-create starts the path fresh.  Every namespace
    # replay is idempotent (the op may have been applied just before the
    # crash, or by an earlier recover() attempt that failed midway).
    # ``last_group`` lets the failure path tell which files had already
    # fully replayed when a backend call threw.
    files: Dict[str, object] = {}
    last_group: Dict[str, int] = {}
    for gi, (_seq, _sid, entries) in enumerate(valid):
        if entries[0].fdid == META_FDID:
            _op, _f, _aux, a, b = decode_meta(
                b"".join(bytes(e.data) for e in entries))
            last_group[a] = gi
            if b:
                last_group[b] = gi
            continue
        path = log.fd_table_get(entries[0].fdid)
        if path is not None:
            last_group[path] = gi
    # the backend's applied watermark: the seq of the last namespace op it
    # already reflects (a journaling backend records it as part of the op).
    # Replaying an op at/below it is NOT idempotent — the backend state has
    # moved past it (its covered data drained, its paths re-created) and a
    # second rename/unlink would tear exactly what the first one built.
    ns_seq = getattr(tier, "ns_seq", 0)
    # dead-fdid barrier: once an unlink of fdid F is processed (replayed OR
    # already applied), any LATER data group still carrying F belongs to
    # the anonymous (unlinked-while-open) file and died with the name — a
    # writer racing the unlink's fd-table clear could otherwise resurrect
    # the path holding only its own bytes.  A later MOP_CREATE re-binding F
    # lifts the barrier (fdid reuse after the old file drained; the create
    # is in the same shard as the unlink, so it can never be consumed while
    # the unlink survives in the log).
    dead: Dict[int, str] = {}
    done_groups = 0
    try:
        for gi, (seq, gsid, entries) in enumerate(valid):
            if entries[0].fdid == META_FDID:
                op, mfdid, _aux, a, _b = decode_meta(
                    b"".join(bytes(e.data) for e in entries))
                if op == MOP_UNLINK and mfdid != META_NO_FDID:
                    dead[mfdid] = a
                elif op == MOP_CREATE:
                    dead.pop(mfdid, None)
                if seq <= ns_seq:
                    stats.meta_skipped += 1
                else:
                    _replay_meta(entries, tier, open_backend, files)
                    stats.meta_ops += 1
                    if tier is not None:
                        tier.ns_seq = seq      # the backend now reflects it
                done_groups = gi + 1
                continue
            path = log.fd_table_get(entries[0].fdid)
            if path is None:
                continue  # orphan group: its file slot was already retired
            if dead.get(entries[0].fdid) == path:
                # fdid unlinked at a lower seq and not re-bound since (a
                # different live binding would show a different slot path)
                stats.unlinked_dropped += 1
                done_groups = gi + 1
                continue
            f = files.get(path)
            if f is None:
                f = open_backend(path)
                files[path] = f
            for e in entries:
                f.pwrite(bytes(e.data), e.off)
                stats.entries_replayed += 1
                stats.bytes_replayed += e.length
            if gsid == policy.shards:
                stats.frames_replayed += 1
            done_groups = gi + 1
    except BaseException:
        # a raising open_backend/pwrite must not leak the already-opened
        # handles or fsync files whose replay never finished; the log stays
        # intact so the caller can retry (replay is idempotent).  Cleanup
        # errors must not mask the original exception.
        _finish(files, last_group, done_groups, suppress=True)
        raise
    _finish(files, last_group, done_groups)
    stats.files = len(files)

    # paper: "empties the log" — reformat the region for the next run
    # (reached only on success; the reformat also clears the route record)
    NVLog(nvmm, policy, format=True)
    return stats


def _replay_meta(entries: List[Entry], tier, open_backend,
                 files: Dict[str, object]) -> None:
    """Apply one namespace record to the backend (idempotently — the op may
    already have been applied pre-crash, or by a failed earlier recover()
    attempt).  ``files`` is the replay's open-handle cache: unlink/rename
    must invalidate (or re-key) its entries, or later data groups for a
    re-created path would write through a handle the tier no longer owns."""
    op, _fdid, aux, a, b = decode_meta(
        b"".join(bytes(e.data) for e in entries))
    if op == MOP_CREATE:
        open_backend(a).close()       # ensure the path exists
    elif op == MOP_FTRUNCATE:
        f = files.get(a)
        if f is None:
            f = files[a] = open_backend(a)
        f.truncate(aux)
    elif op == MOP_UNLINK:
        if tier is None:
            raise RuntimeError("unlink record needs a tier-like backend "
                               "(pass the tier to recover())")
        h = files.pop(a, None)
        if h is not None:
            h.close()
        tier.unlink(a)                # idempotent: a no-op when already gone
    elif op == MOP_RENAME:
        if tier is None:
            raise RuntimeError("rename record needs a tier-like backend "
                               "(pass the tier to recover())")
        hb = files.pop(b, None)
        if hb is not None:
            hb.close()                # destination is replaced
        ha = files.pop(a, None)
        if tier.exists(a):
            tier.rename(a, b)
            if ha is not None:
                files[b] = ha         # same backend object, re-keyed
        else:
            if ha is not None:
                ha.close()
            if not tier.exists(b):    # both lost: restore the destination
                open_backend(b).close()
    else:
        raise ValueError(f"unknown namespace op {op}")


def _finish(files: Dict[str, object], last_group: Dict[str, int],
            done_groups: int, *, suppress: bool = False) -> None:
    """Fsync every file whose groups all replayed, then close ALL handles
    (even on fsync failure — the first error propagates after the closes,
    unless ``suppress`` because a replay exception is already in flight)."""
    first_err: BaseException | None = None
    for path, f in files.items():
        try:
            if last_group.get(path, -1) < done_groups:
                f.fsync()
        except BaseException as exc:
            if first_err is None:
                first_err = exc
        finally:
            try:
                f.close()
            except BaseException as exc:
                if first_err is None:
                    first_err = exc
    if first_err is not None and not suppress:
        raise first_err
