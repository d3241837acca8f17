"""The paged NVMM region (layout VERSION 4): in-place dual persistence.

The log (:mod:`repro.core.log`) makes every committed byte pay a double
copy — once into the NVMM log, once again when the drain propagates it to
the backend.  For small synchronous writes that is the right trade (one
fetch-and-add, one flush); for large sequential streams and rewrite-heavy
files it is pure overhead, and the same data keeps transiting the log and
the backend over and over.  The paged region is the second mode (cf. "NVMM
cache design: Logging vs. Paging" and Libnvmmio's per-file mmap idiom): a
pool of ``policy.page_frames`` fixed *frames*, each binding one
(fdid, page) to NVMM-resident bytes that are updated **in place** — an
overwrite replaces the frame's image and appends nothing anywhere.  The
frame then flushes to the backend at most once, lazily (writeback), no
matter how many times it was rewritten.

Frame layout (``policy.frame_size`` bytes each, at ``policy.frame_base(i)``)::

    [header: 1 cacheline | data slot 0: page_size | data slot 1: page_size]

    header = state u32 (0 free / 1 mapped), slot u32 (active data slot),
             page_no u64, seq u64, fdid u32, length u32, crc u32

Commit protocol (ping-pong undo, pwb/pfence/psync-ordered): the new page
image is built in the *inactive* slot, flushed, fenced, and then the
header — which fits one cacheline, so its store is atomic under the crash
model — is rewritten to point at it::

    store(inactive slot, image) -> pwb -> pfence
    -> store(header{slot=inactive, seq, length, crc}) -> pwb -> psync

A crash anywhere leaves either the old header (old image intact in the
still-untouched old slot) or the new header (new image fenced durable
before the flip) — per-page old-or-new, never torn.  ``seq`` is drawn from
the same global counter as log groups (``NVLog.next_seq``), which is the
whole recovery story: :mod:`repro.core.recovery` folds each mapped frame
into the log's cross-shard merge as a one-entry group and replays strictly
by ascending seq, so frames order correctly against log writes, metadata
ops (truncate/unlink/rename) and each other.

Volatile state (rebuilt by :meth:`PagedRegion.attach`, irrelevant after a
crash because recovery replays frames to the backend and reformats): the
free list, the dirty set (frames whose image is newer than the backend),
and the owner map for writeback.  Frame *reuse* is the one place a durable
invalidate matters: a freed frame's header must be durably zeroed before
the frame can be re-allocated, otherwise a crash between the new owner's
slot fill and its header flip could resurrect the old header over the new
owner's bytes.  :meth:`invalidate` batches exactly that
(store+pwb per frame, one psync) before returning frames to the free list.
"""
from __future__ import annotations

import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core import locking
from repro_torch.core.nvmm import NVMM
from repro_torch.core.policy import FRAME_HDR, Policy

_FR = struct.Struct("<IIQQIII")  # state, slot, page_no, seq, fdid, length, crc
assert _FR.size <= FRAME_HDR

FR_FREE = 0
FR_MAPPED = 1


class FrameRec:
    """Decoded view of one mapped frame (recovery / attach scan)."""

    __slots__ = ("idx", "slot", "page_no", "seq", "fdid", "length", "crc",
                 "data")

    def __init__(self, idx, slot, page_no, seq, fdid, length, crc, data):
        self.idx = idx
        self.slot = slot
        self.page_no = page_no
        self.seq = seq
        self.fdid = fdid
        self.length = length
        self.crc = crc
        self.data = data  # memoryview of the active slot's length bytes


def scan_frames(nvmm: NVMM, policy: Policy) -> Iterator[FrameRec]:
    """Yield every mapped frame's header + active image.  Pure read — used
    by recovery's merge and by :meth:`PagedRegion.attach`."""
    ps = policy.page_size
    for i in range(policy.page_frames):
        base = policy.frame_base(i)
        state, slot, page_no, seq, fdid, length, crc = _FR.unpack_from(
            nvmm.load(base, _FR.size))
        if state != FR_MAPPED or slot > 1 or length > ps:
            continue
        data = nvmm.load(base + FRAME_HDR + slot * ps, length)
        yield FrameRec(i, slot, page_no, seq, fdid, length, crc, data)


def max_frame_seq(nvmm: NVMM, policy: Policy) -> int:
    return max((fr.seq for fr in scan_frames(nvmm, policy)), default=0)


class PagedRegion:
    """Frame pool manager.  Thread safety: pool state (free list, dirty
    set, owner map) is guarded by ``self.lock``; the *content* of a frame
    is guarded by its page's ``PageDesc.atomic_lock``, which every caller
    (write path, read miss, writeback, invalidate) already holds — so one
    frame is never written and read concurrently."""

    GUARDED_BY = {
        "free": "lock", "dirty": "lock", "owner": "lock", "_tick": "lock",
        "stats_frame_writes": "lock", "stats_frame_bytes": "lock",
        "stats_cow_bytes": "lock", "stats_writebacks": "lock",
        "stats_invalidated": "lock", "stats_alloc_fail": "lock",
    }

    def __init__(self, nvmm: NVMM, policy: Policy, seq_source):
        self.nvmm = nvmm
        self.policy = policy
        self.page_size = policy.page_size
        self.seq_source = seq_source          # NVLog.next_seq
        self.lock = locking.make_lock("pager_free")
        # guarded-by: lock — the whole pool state (free list, dirty set,
        # owner map, tick) and every stats counter below
        self.free: List[int] = list(range(policy.page_frames - 1, -1, -1))
        self.dirty: Dict[int, int] = {}       # idx -> dirty tick (FIFO age)
        self.owner: Dict[int, Tuple[int, int]] = {}  # idx -> (fdid, page_no)
        self._tick = 0
        self.pressure = threading.Event()     # wakes the writeback thread
        self.stats_frame_writes = 0
        self.stats_frame_bytes = 0            # committed bytes absorbed
        self.stats_cow_bytes = 0              # old bytes re-copied (partial
        #                                       overwrites pay the ping-pong)
        self.stats_writebacks = 0             # frames flushed to the backend
        self.stats_invalidated = 0
        self.stats_alloc_fail = 0             # pool-exhausted log fallbacks

    def attach(self) -> Dict[int, Dict[int, int]]:
        """Rebuild pool state from the region; returns per-fdid frame maps
        ``{fdid: {page_no: idx}}`` for the owner to hand to its files.  All
        surviving frames are conservatively marked dirty (the backend may
        or may not have their bytes — rewriting is idempotent)."""
        mapped: Dict[int, Dict[int, int]] = {}
        with self.lock:
            self.free = []
            self.dirty.clear()
            self.owner.clear()
            for fr in scan_frames(self.nvmm, self.policy):
                mapped.setdefault(fr.fdid, {})[fr.page_no] = fr.idx
                self.owner[fr.idx] = (fr.fdid, fr.page_no)
                self._tick += 1
                self.dirty[fr.idx] = self._tick
            used = set(self.owner)
            self.free = [i for i in range(self.policy.page_frames - 1, -1, -1)
                         if i not in used]
        return mapped

    # ------------------------------------------------------------------ pool
    def alloc(self, fdid: int, page_no: int) -> Optional[int]:
        """Reserve a frame for (fdid, page_no); None when the pool is empty
        (the caller falls back to the log and the writeback path reclaims).
        Non-blocking by design: a writer holds page atomic locks here, and
        the writeback thread needs those same locks to free frames."""
        with self.lock:
            if not self.free:
                self.stats_alloc_fail += 1
                self.pressure.set()
                return None
            idx = self.free.pop()
            self.owner[idx] = (fdid, page_no)
            if len(self.free) < (1.0 - self.policy.page_wb_watermark) * \
                    self.policy.page_frames:
                self.pressure.set()
            return idx

    def invalidate(self, idxs) -> None:
        """Durably free frames: zero each header (store+pwb), one psync,
        then return them to the free list.  See the module docstring for
        why the psync must precede reuse.  Caller holds the pages' atomic
        locks and has already removed the File-side mappings."""
        idxs = list(idxs)
        if not idxs:
            return
        for idx in idxs:
            base = self.policy.frame_base(idx)
            self.nvmm.store(base, b"\x00" * _FR.size)
            self.nvmm.pwb(base, _FR.size)
        self.nvmm.psync()
        with self.lock:
            for idx in idxs:
                self.owner.pop(idx, None)
                self.dirty.pop(idx, None)
                self.free.append(idx)
                self.stats_invalidated += 1

    # ----------------------------------------------------------------- write
    def frame_write(self, idx: int, fdid: int, page_no: int, s: int, e: int,
                    data, base_image: Optional[bytes], valid: int) -> None:
        """Commit one write of ``data`` into page range ``[s, e)`` of frame
        ``idx`` — the in-place overwrite protocol (module docstring).

        ``base_image``/``valid`` seed a *fresh* frame: the page's committed
        bytes (None == the frame already holds them in its active slot) and
        how many of them are meaningful.  Caller holds the page's
        atomic_lock.
        """
        ps = self.page_size
        fb = self.policy.frame_base(idx)
        state, slot, pno, _seq, _fdid, length, _crc = _FR.unpack_from(
            self.nvmm.load(fb, _FR.size))
        if state == FR_MAPPED:
            if pno != page_no:
                raise RuntimeError("frame/page mismatch (stale mapping)")
            new_slot = 1 - slot
            old = self.nvmm.load(fb + FRAME_HDR + slot * ps, length)
        else:
            new_slot, length = 0, min(valid, ps)
            old = (base_image or b"")[:length]
        img = bytearray(max(length, e))
        img[:len(old)] = old
        img[s:e] = data
        new_len = len(img)
        cow = max(0, len(old) - (e - s))
        crc = zlib.crc32(bytes(img)) if self.policy.verify_crc else 0
        seq = self.seq_source()
        doff = fb + FRAME_HDR + new_slot * ps
        self.nvmm.store(doff, bytes(img))
        self.nvmm.pwb(doff, new_len)
        self.nvmm.pfence()
        self.nvmm.store(fb, _FR.pack(FR_MAPPED, new_slot, page_no, seq,
                                     fdid, new_len, crc))
        self.nvmm.pwb(fb, _FR.size)
        self.nvmm.psync()
        with self.lock:
            self._tick += 1
            self.dirty.setdefault(idx, self._tick)
            self.stats_frame_writes += 1
            self.stats_frame_bytes += e - s
            # counted here, not at the unlocked computation site: two
            # writers in frame_write for different pages race otherwise
            self.stats_cow_bytes += cow

    def truncate_frame(self, idx: int, new_len: int) -> None:
        """Durably clip a frame's valid length (file shrank mid-page): a
        header-only rewrite — the active image is untouched."""
        ps = self.page_size
        fb = self.policy.frame_base(idx)
        state, slot, pno, _seq, fdid, length, _crc = _FR.unpack_from(
            self.nvmm.load(fb, _FR.size))
        if state != FR_MAPPED or new_len >= length:
            return
        img = self.nvmm.load(fb + FRAME_HDR + slot * ps, new_len)
        crc = zlib.crc32(bytes(img)) if self.policy.verify_crc else 0
        seq = self.seq_source()
        self.nvmm.store(fb, _FR.pack(FR_MAPPED, slot, pno, seq, fdid,
                                     new_len, crc))
        self.nvmm.pwb(fb, _FR.size)
        self.nvmm.psync()
        with self.lock:
            self._tick += 1
            self.dirty.setdefault(idx, self._tick)

    # ------------------------------------------------------------------ read
    def read(self, idx: int) -> Tuple[memoryview, int]:
        """Active image of a mapped frame as ``(view, length)``.  Caller
        holds the page's atomic_lock (no concurrent flip)."""
        ps = self.page_size
        fb = self.policy.frame_base(idx)
        state, slot, _pno, _seq, _fdid, length, _crc = _FR.unpack_from(
            self.nvmm.load(fb, _FR.size))
        if state != FR_MAPPED:
            raise RuntimeError(f"read of unmapped frame {idx}")
        return self.nvmm.load(fb + FRAME_HDR + slot * ps, length), length

    # ------------------------------------------------------------- writeback
    def mark_clean(self, idx: int) -> None:
        with self.lock:
            self.dirty.pop(idx, None)
            self.stats_writebacks += 1

    def dirty_victims(self, limit: int) -> Dict[int, List[int]]:
        """Oldest-first dirty frames grouped by owning fdid (for the
        background writeback path), at most ``limit`` frames."""
        with self.lock:
            oldest = sorted(self.dirty, key=self.dirty.__getitem__)[:limit]
            out: Dict[int, List[int]] = {}
            for idx in oldest:
                own = self.owner.get(idx)
                if own is not None:
                    out.setdefault(own[0], []).append(idx)
            return out

    def over_watermark(self) -> bool:
        with self.lock:
            n = self.policy.page_frames
            return n > 0 and len(self.dirty) >= self.policy.page_wb_watermark * n

    @property
    def frames_used(self) -> int:
        with self.lock:
            return self.policy.page_frames - len(self.free)

    @property
    def frames_dirty(self) -> int:
        with self.lock:
            return len(self.dirty)

    def snapshot_stats(self) -> Dict[str, int]:
        """Coherent point-in-time copy of the pool counters (api.stats()
        reads this instead of the live fields — the writeback thread and
        concurrent writers mutate them under ``lock``)."""
        with self.lock:
            return {
                "frame_writes": self.stats_frame_writes,
                "frame_bytes": self.stats_frame_bytes,
                "cow_bytes": self.stats_cow_bytes,
                "writebacks": self.stats_writebacks,
                "invalidated": self.stats_invalidated,
                "alloc_fail": self.stats_alloc_fail,
                "frames_used": self.policy.page_frames - len(self.free),
                "frames_dirty": len(self.dirty),
            }
