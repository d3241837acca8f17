"""A minimal POSIX-ish file-system interface so that "legacy" components
(kvlite, the checkpoint codec, metrics writers, the data pipeline) run
unmodified over either NVCache or a raw tier — the paper's plug-and-play
boundary, one level above libc.
"""
from __future__ import annotations

from typing import Protocol

from repro_torch.core.api import NVCache, O_CREAT, O_RDWR


class FS(Protocol):
    def open(self, path: str) -> int: ...
    def open_ro(self, path: str) -> int: ...
    def pread(self, fd: int, n: int, off: int) -> bytes: ...
    def pwrite(self, fd: int, data: bytes, off: int) -> int: ...
    def write(self, fd: int, data: bytes) -> int: ...
    def fsync(self, fd: int) -> None: ...
    def close(self, fd: int) -> None: ...
    def size(self, fd: int) -> int: ...
    # namespace surface (the metadata half of the plug-and-play boundary —
    # what SQLite's journal unlink / WAL reset and RocksDB's MANIFEST
    # rename-into-place actually call):
    def exists(self, path: str) -> bool: ...
    def unlink(self, path: str) -> None: ...
    def rename(self, old: str, new: str) -> None: ...
    def ftruncate(self, fd: int, length: int) -> None: ...


class NVCacheFS:
    """Files routed through NVCache: synchronous durability, fsync no-op."""

    def __init__(self, nv: NVCache):
        self.nv = nv

    def open(self, path: str) -> int:
        return self.nv.open(path, O_RDWR | O_CREAT)

    def open_ro(self, path: str) -> int:
        # read-only open bypasses the read cache entirely (paper §II-A)
        import os
        return self.nv.open(path, os.O_RDONLY)

    def pread(self, fd, n, off):
        return self.nv.pread(fd, n, off)

    def pwrite(self, fd, data, off):
        return self.nv.pwrite(fd, data, off)

    def write(self, fd, data):
        return self.nv.write(fd, data)

    def fsync(self, fd):
        self.nv.fsync(fd)          # no-op (paper Table III)

    def close(self, fd):
        self.nv.close(fd)

    def size(self, fd):
        return self.nv.stat_size(fd)

    # namespace ops: journaled in the NVMM log (core/namespace.py), so a
    # rename/unlink the app observed is crash-durable — unlike the raw
    # TierFS below, where only what reached the device survives
    def exists(self, path):
        if self.nv.ns.lookup(path) is not None:
            return True
        return self.nv.tier.exists(path)

    def unlink(self, path):
        self.nv.unlink(path)

    def rename(self, old, new):
        self.nv.rename(old, new)

    def ftruncate(self, fd, length):
        self.nv.ftruncate(fd, length)


class TierFS:
    """Files directly on a tier (the baselines).

    ``sync_each``: force synchronous durability the legacy way — an fsync
    after every write (the paper's "synchronous mode" of db_bench).  On a
    ``sync=True`` tier (O_SYNC/O_DIRECT model) the write itself already
    paid device cost, and fsync is cheap.
    """

    def __init__(self, tier, *, sync_each: bool = False):
        self.tier = tier
        self.sync_each = sync_each
        self._fds: dict[int, object] = {}
        self._cursor: dict[int, int] = {}
        self._next = 3

    def open(self, path: str) -> int:
        fd = self._next
        self._next += 1
        self._fds[fd] = self.tier.open(path)
        self._cursor[fd] = 0
        return fd

    def open_ro(self, path: str) -> int:
        return self.open(path)

    def pread(self, fd, n, off):
        return self._fds[fd].pread(n, off)

    def pwrite(self, fd, data, off):
        n = self._fds[fd].pwrite(data, off)
        if self.sync_each:
            self._fds[fd].fsync()
        return n

    def write(self, fd, data):
        off = self._cursor[fd]
        n = self.pwrite(fd, data, off)
        self._cursor[fd] = off + n
        return n

    def fsync(self, fd):
        self._fds[fd].fsync()

    def close(self, fd):
        self._fds.pop(fd).close()
        self._cursor.pop(fd, None)

    def size(self, fd):
        return self._fds[fd].size()

    def exists(self, path):
        return self.tier.exists(path)

    def unlink(self, path):
        self.tier.unlink(path)

    def rename(self, old, new):
        self.tier.rename(old, new)

    def ftruncate(self, fd, length):
        self._fds[fd].truncate(length)
