"""Storage-tier device models (evaluation substrate for the paper's figures).

The paper's machine has Optane NVDIMMs (µs writes, GB/s) in front of a SATA
SSD (~80 MiB/s random-4k-with-fsync, ~ms fsync).  This container has one
real disk and a 1-core CPU, so throughput ratios between tiers would be
noise.  We therefore model devices *analytically*: every operation charges a
cost to a :class:`CostGate` which converts owed time into real sleeps in
chunks (per-op ``time.sleep`` of microseconds is impossible; aggregated
sleeping preserves throughput shapes exactly).

Semantics mirror the kernel model the paper relies on:

* ``buffered`` files: ``pwrite`` lands in a volatile page cache (cheap,
  write-combining by page — the paper's "kernel combines the writes"),
  ``fsync`` pays per *unique dirty page* at device random-write cost plus a
  base latency.  This is what the NVCache cleanup thread writes to.
* ``sync`` files: every ``pwrite`` pays device cost immediately
  (O_SYNC/O_DIRECT-style baselines).

Content lives in memory (bytearray per file) — durability across a process
restart is out of scope for benchmarks; crash-consistency tests use the NVMM
shadow instead.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Cost model of one device (all costs in seconds)."""

    name: str
    page_write_s: float          # random 4-KiB page write (durable)
    seq_write_bps: float         # sequential streaming bandwidth
    page_read_s: float           # uncached 4-KiB read
    fsync_base_s: float          # per-fsync fixed latency
    syscall_s: float = 2e-6      # per-syscall overhead on this path
    iov_seg_s: float = 0.3e-6    # per-extra-segment overhead of pwritev
    #                              (kernel iterates the iovec inside ONE
    #                               syscall: far cheaper than a syscall each)


# Calibrated to the paper's hardware (§IV-A): SATA SSD ~80 MiB/s random-4k
# synchronous writes, Optane ~2.3 GB/s writes with ~µs latency.
SSD_SATA = DeviceProfile("ssd", page_write_s=48e-6, seq_write_bps=460e6,
                         page_read_s=90e-6, fsync_base_s=300e-6)
NVMM_OPTANE = DeviceProfile("nvmm", page_write_s=1.7e-6, seq_write_bps=2.3e9,
                            page_read_s=1.2e-6, fsync_base_s=0.0, syscall_s=0.0)
DRAM = DeviceProfile("dram", page_write_s=0.0, seq_write_bps=0.0,
                     page_read_s=0.0, fsync_base_s=0.0, syscall_s=0.5e-6)
# Blob-store-class backend for checkpoint benches (high bw, high latency).
BLOB = DeviceProfile("blob", page_write_s=8e-6, seq_write_bps=1.2e9,
                     page_read_s=30e-6, fsync_base_s=15e-3)


class CostGate:
    """Converts modeled device time into wall time with chunked sleeping.

    Owed time is tracked PER THREAD: the cleanup thread's drain costs must
    never be paid by an application thread that happens to touch the gate
    (that would serialize exactly the overlap the paper's design buys)."""

    SLEEP_CHUNK = 2e-3

    def __init__(self, scale: float = 1.0):
        self.scale = scale          # <1.0 speeds up benchmarks uniformly
        self._local = threading.local()
        self._lock = threading.Lock()
        self.total_cost = 0.0

    def charge(self, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self.total_cost += seconds
        owed = getattr(self._local, "owed", 0.0) + seconds * self.scale
        if owed < self.SLEEP_CHUNK:
            self._local.owed = owed
            return
        self._local.owed = 0.0
        time.sleep(owed)


PAGE = 4096


class TierFile:
    """One file on a modeled device."""

    def __init__(self, path: str, device: DeviceProfile, gate: CostGate,
                 *, sync: bool, volatile: bool = False):
        self.path = path
        self.device = device
        self.gate = gate
        self.sync = sync              # True: every pwrite is durable (pays now)
        self.volatile = volatile      # True: fsync is a no-op that buys nothing
        self._data = bytearray()
        self._dirty_pages: set[int] = set()
        self._cached_pages: set[int] = set()   # kernel page cache (reads free)
        self._lock = threading.Lock()
        self.stats_writes = 0
        self.stats_fsyncs = 0
        self.stats_bytes = 0
        self.stats_page_writes = 0    # pages touched by write calls (the
        #                               drain-coalescing figure of merit)
        self.stats_wvec_segments = 0  # iovec segments across pwritev calls
        self.stats_preads = 0         # read syscalls (pread + preadv calls —
        #                               the readahead figure of merit)
        self.stats_page_reads = 0     # uncached pages paid at device cost
        self.stats_rvec_segments = 0  # iovec segments across preadv calls

    # -- data plane ---------------------------------------------------------
    def pwrite(self, data: bytes, off: int) -> int:
        n = len(data)
        with self._lock:
            end = off + n
            if end > len(self._data):
                self._data.extend(b"\x00" * (end - len(self._data)))
            self._data[off:end] = data
            pages = range(off // PAGE, (end - 1) // PAGE + 1) if n else ()
            npages = len(pages)
            self._cached_pages.update(pages)   # writes populate the page cache
            if not self.sync:
                self._dirty_pages.update(pages)
        self.stats_writes += 1
        self.stats_bytes += n
        self.stats_page_writes += npages
        cost = self.device.syscall_s
        if self.sync:
            cost += npages * self.device.page_write_s
        self.gate.charge(cost)
        return n

    def pwritev(self, iov) -> int:
        """Vectored write: ``iov`` is an iterable of ``(data, off)``.

        One syscall's worth of overhead for the whole vector plus a small
        per-extra-segment cost (``iov_seg_s``) — the extent/vectored cost
        model the coalescing drain engine is measured against.  Page-cache
        and dirty accounting are identical to issuing the segments
        individually; a page touched by several segments is still counted
        (and, on sync devices, charged) once per call.
        """
        total = 0
        nseg = 0
        touched: set[int] = set()
        with self._lock:
            for data, off in iov:
                n = len(data)
                if n == 0:
                    continue
                nseg += 1
                end = off + n
                if end > len(self._data):
                    self._data.extend(b"\x00" * (end - len(self._data)))
                self._data[off:end] = data
                pages = range(off // PAGE, (end - 1) // PAGE + 1)
                touched.update(pages)
                self._cached_pages.update(pages)
                if not self.sync:
                    self._dirty_pages.update(pages)
                total += n
        self.stats_writes += 1
        self.stats_bytes += total
        self.stats_page_writes += len(touched)
        self.stats_wvec_segments += nseg
        cost = self.device.syscall_s + max(0, nseg - 1) * self.device.iov_seg_s
        if self.sync:
            cost += len(touched) * self.device.page_write_s
        self.gate.charge(cost)
        return total

    def pread(self, n: int, off: int) -> bytes:
        with self._lock:
            out = bytes(self._data[off:off + n])
            pages = range(off // PAGE, (off + max(n, 1) - 1) // PAGE + 1)
            misses = [p for p in pages if p not in self._cached_pages]
            self._cached_pages.update(misses)
        self.stats_preads += 1
        self.stats_page_reads += len(misses)
        self.gate.charge(self.device.syscall_s + len(misses) * self.device.page_read_s)
        return out

    def preadv(self, iov) -> list:
        """Vectored read: ``iov`` is an iterable of ``(n, off)``; returns the
        list of chunks (short chunks past EOF, like ``pread``).

        One syscall's worth of overhead for the whole vector plus a small
        per-extra-segment cost (``iov_seg_s``) plus device cost per
        *uncached* page — the extent/vectored cost model the readahead miss
        path is measured against.  Page-cache accounting is identical to
        issuing the segments individually.
        """
        out = []
        nseg = 0
        misses = 0
        with self._lock:
            for n, off in iov:
                out.append(bytes(self._data[off:off + n]))
                if n <= 0:
                    continue
                nseg += 1
                pages = range(off // PAGE, (off + n - 1) // PAGE + 1)
                miss = [p for p in pages if p not in self._cached_pages]
                misses += len(miss)
                self._cached_pages.update(miss)
        self.stats_preads += 1
        self.stats_page_reads += misses
        self.stats_rvec_segments += nseg
        self.gate.charge(self.device.syscall_s
                         + max(0, nseg - 1) * self.device.iov_seg_s
                         + misses * self.device.page_read_s)
        return out

    def fsync(self) -> None:
        self.stats_fsyncs += 1
        if self.volatile or self.sync:
            self.gate.charge(self.device.syscall_s)
            return
        with self._lock:
            npages = len(self._dirty_pages)
            self._dirty_pages.clear()
        self.gate.charge(self.device.fsync_base_s + npages * self.device.page_write_s
                         + self.device.syscall_s)

    def drop_page_cache(self) -> None:
        """Evict this file's clean pages from the modeled kernel page cache
        (the per-file half of ``echo 3 > drop_caches``) — cold-read
        benchmarks use it so reads pay device cost.  Dirty pages stay: the
        kernel cannot drop them before writeback."""
        with self._lock:
            self._cached_pages &= self._dirty_pages

    def size(self) -> int:
        with self._lock:
            return len(self._data)

    def truncate(self, n: int) -> None:
        with self._lock:
            if n < len(self._data):
                del self._data[n:]
                # drop page-cache/dirty state beyond the new size: a later
                # fsync must not pay device cost for pages that no longer
                # exist (the page holding byte n-1 survives — it may still
                # be dirty)
                last = (n + PAGE - 1) // PAGE  # first wholly-truncated page
                self._dirty_pages = {p for p in self._dirty_pages if p < last}
                self._cached_pages = {p for p in self._cached_pages if p < last}
            elif n > len(self._data):
                # ftruncate growth: sparse zero extension (no dirty pages —
                # the kernel materializes holes lazily)
                self._data.extend(b"\x00" * (n - len(self._data)))
        self.gate.charge(self.device.syscall_s)

    def close(self) -> None:
        pass

    def snapshot(self) -> bytes:
        with self._lock:
            return bytes(self._data)


class Tier:
    """A namespace of files on one device model (a mounted filesystem)."""

    def __init__(self, device: DeviceProfile = SSD_SATA, *, sync: bool = False,
                 volatile: bool = False, scale: float = 1.0):
        self.device = device
        self.sync = sync
        self.volatile = volatile
        self.gate = CostGate(scale)
        self._files: Dict[str, TierFile] = {}
        self._lock = threading.Lock()
        self.ns_seq = 0     # applied-watermark of the durable namespace
        #                     (repro.core.namespace): the seq of the last
        #                     metadata op reflected in this tier's dict —
        #                     set by the owner as part of applying, read by
        #                     recovery to replay exactly the ops above it

    def open(self, path: str) -> TierFile:
        with self._lock:
            f = self._files.get(path)
            if f is None:
                f = TierFile(path, self.device, self.gate, sync=self.sync,
                             volatile=self.volatile)
                self._files[path] = f
            return f

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._files

    def size_of(self, path: str) -> int:
        """Size of an existing file WITHOUT creating it on miss — the
        non-mutating stat path (``Tier.open`` inserts on miss, which a
        stat of a nonexistent path must never do)."""
        with self._lock:
            f = self._files.get(path)
        if f is None:
            raise FileNotFoundError(path)
        return f.size()

    def unlink(self, path: str) -> None:
        with self._lock:
            self._files.pop(path, None)
        self.gate.charge(self.device.syscall_s)

    def rename(self, old: str, new: str) -> None:
        """Atomic rename-into-place (the install primitive of the legacy
        metadata protocols): an existing ``new`` is replaced.  The moved
        :class:`TierFile` handle stays valid — I/O through it is
        path-independent, like an open fd across a rename."""
        with self._lock:
            f = self._files.pop(old, None)
            if f is None:
                raise FileNotFoundError(old)
            self._files[new] = f
            f.path = new
        self.gate.charge(self.device.syscall_s)

    def paths(self):
        return list(self._files)


class DMWriteCacheTier(Tier):
    """DM-WriteCache analogue (paper Table IV): an NVMM write cache *behind*
    the kernel page cache.  Synchronous durability requires O_SYNC through
    the kernel: each write pays the kernel block path + an NVMM commit, and
    once the NVMM cache is full, drains at SSD speed (paper Fig. 4: slower
    than NVCache for sync writes, faster than the bare SSD)."""

    def __init__(self, *, cache_bytes: int = 1 << 30, scale: float = 1.0):
        super().__init__(SSD_SATA, sync=True, scale=scale)
        self.cache_bytes = cache_bytes
        self._outstanding = 0
        self._last = time.monotonic()
        self._dm_lock = threading.Lock()

    def open(self, path: str) -> TierFile:
        f = super().open(path)
        # wrap exactly once: re-opening the same path used to stack another
        # wrapper on the already-wrapped bound method, double-charging the
        # NVMM commit cost (and double-counting stats) per reopen
        if not getattr(f, "_dm_wrapped", False):
            f.pwrite = self._wrap_pwrite(f)  # type: ignore[method-assign]
            # dm-writecache sits below the kernel block layer: a vectored
            # write still pays the block path per segment, so route pwritev
            # through the wrapped pwrite rather than the free base model
            f.pwritev = lambda iov: sum(f.pwrite(d, o) for d, o in iov)  # type: ignore[method-assign]
            f._dm_wrapped = True             # type: ignore[attr-defined]
        return f

    def _wrap_pwrite(self, f: TierFile):
        inner_data = f

        def pwrite(data: bytes, off: int) -> int:
            n = len(data)
            npages = 0
            with inner_data._lock:
                end = off + n
                if end > len(inner_data._data):
                    inner_data._data.extend(b"\x00" * (end - len(inner_data._data)))
                inner_data._data[off:end] = data
                if n:
                    pages = range(off // PAGE, (end - 1) // PAGE + 1)
                    npages = len(pages)
                    inner_data._cached_pages.update(pages)
            # kernel block path + commit record into NVMM (two flushed lines)
            cost = 6e-6 + max(1, (n + PAGE - 1) // PAGE) * (NVMM_OPTANE.page_write_s + 4e-6)
            with self._dm_lock:
                now = time.monotonic()
                drained = (now - self._last) * SSD_SATA.seq_write_bps
                self._last = now
                self._outstanding = max(0, self._outstanding - drained) + n
                if self._outstanding > self.cache_bytes:
                    # cache full: writes proceed at SSD drain speed
                    cost += max(1, (n + PAGE - 1) // PAGE) * SSD_SATA.page_write_s
                    self._outstanding = self.cache_bytes
            self.gate.charge(cost)
            f.stats_writes += 1
            f.stats_bytes += n
            f.stats_page_writes += npages
            return n

        return pwrite
