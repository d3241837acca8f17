"""kvlite — a small log-structured embedded KV store.

Stands in for SQLite/RocksDB in the paper's §IV benchmarks: it is a
*legacy application* in the paper's sense — it persists through plain
file calls (append record, fsync, pread) and knows nothing about NVMM.
Running it over :class:`NVCacheFS` vs :class:`TierFS` reproduces the
paper's transparent-boost experiment.

Record format (append-only data log)::

    u32 klen | u32 vlen | key | value

An in-memory hash index maps key -> (offset, vlen).  ``sync`` mode calls
fsync after every put (db_bench synchronous mode).
"""
from __future__ import annotations

import struct
from typing import Optional

from repro_torch.storage.fsapi import FS

_REC = struct.Struct("<II")


class KVLite:
    def __init__(self, fs: FS, path: str = "/kvlite.db", *, sync: bool = True):
        self.fs = fs
        self.sync = sync
        self.fd = fs.open(path)
        self._index: dict[bytes, tuple[int, int]] = {}
        self._end = fs.size(self.fd)
        if self._end:
            self._replay()

    def _replay(self) -> None:
        off = 0
        while off + _REC.size <= self._end:
            hdr = self.fs.pread(self.fd, _REC.size, off)
            if len(hdr) < _REC.size:
                break
            klen, vlen = _REC.unpack(hdr)
            if off + _REC.size + klen + vlen > self._end:
                # torn tail record: a crash mid-append left a header whose
                # key/value extend past EOF.  Stop at the last complete
                # record — indexing the truncated tail would hand out reads
                # of bytes that were never written (and the next put must
                # overwrite the torn bytes, not append after them).
                break
            key = self.fs.pread(self.fd, klen, off + _REC.size)
            if len(key) < klen:
                break
            self._index[bytes(key)] = (off + _REC.size + klen, vlen)
            off += _REC.size + klen + vlen
        self._end = off

    def put(self, key: bytes, value: bytes) -> None:
        rec = _REC.pack(len(key), len(value)) + key + value
        off = self._end
        self.fs.pwrite(self.fd, rec, off)
        if self.sync:
            self.fs.fsync(self.fd)
        self._index[key] = (off + _REC.size + len(key), len(value))
        self._end = off + len(rec)

    def get(self, key: bytes) -> Optional[bytes]:
        loc = self._index.get(key)
        if loc is None:
            return None
        off, vlen = loc
        return self.fs.pread(self.fd, vlen, off)

    def close(self) -> None:
        self.fs.close(self.fd)

    def __len__(self) -> int:
        return len(self._index)
