"""The file system the benchmark hands the program: the program's
``NVCacheFS`` over an NVCache of the configuration's policy, with the
benchmark's own timer around every ``pwrite`` and a record of every write
acknowledged, which the check reads back once the window has closed."""
from __future__ import annotations

import time


class TimedFS:
    """``fs`` with each acknowledged ``pwrite`` timed and remembered.
    ``window`` switches the timing on and off: only writes made in the
    measured window count towards the mean append time."""

    def __init__(self, fs):
        self.fs = fs
        self.acked = []          # (fd, off, data) of every acknowledged pwrite
        self.window = False
        self.append_s = []       # the window's pwrite times

    def pwrite(self, fd, data, off):
        t0 = time.perf_counter()
        n = self.fs.pwrite(fd, data, off)
        dt = time.perf_counter() - t0
        self.acked.append((fd, off, bytes(data)))
        if self.window:
            self.append_s.append(dt)
        return n

    def __getattr__(self, name):
        return getattr(self.fs, name)

    def lost(self) -> int:
        """How many acknowledged writes do not read back as written."""
        return sum(self.fs.pread(fd, len(data), off) != data for fd, off, data in self.acked)


def open_nvcache(spec: dict):
    """(NVCache, TimedFS) of the configuration's ``nvcache`` entry: its
    ``policy`` keywords over the named backing tier."""
    from repro_torch.core import NVCache, Policy
    from repro_torch.storage import tiers
    from repro_torch.storage.fsapi import NVCacheFS
    nv = NVCache(Policy(**spec["policy"]), tiers.Tier(getattr(tiers, spec["tier"])))
    return nv, TimedFS(NVCacheFS(nv))
