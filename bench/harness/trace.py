"""What a traced window's profiler timeline says: the device's busy time
(the union of its kernel, copy and set intervals), device time by kernel
name, and the idle gaps between device work with the host event (an
operator or a CUDA runtime call) that was running through each.  Read
from the profiler's raw events, which does not build its slow per-event
Python tables."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

GAPS_ATTRIBUTED = 2000     # the longest gaps that are given a host operation


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline: a
    span, not device work."""
    if hasattr(e, "is_user_annotation"):
        return e.is_user_annotation()
    return hasattr(e, "activity_type") and "annotation" in e.activity_type()


def _union(intervals):
    """Sorted, merged copies of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The device and host events of one traced window [t0_ns, t1_ns] (the
    profiler's clock, nanoseconds)."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        self.device, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                self.host.append((e.start_ns(), e.end_ns(), e.name()))
            elif not _annotation(e) and e.duration_ns() > 0:
                self.device.append((e.start_ns(), e.end_ns(), e.name()))
        self.busy = _union((s, e) for s, e, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def device_s(self, names) -> float:
        """Device seconds of the events whose name holds any of ``names``."""
        return sum(e - s for s, e, n in self.device if any(k in n for k in names)) / 1e9

    def top_device_ops(self, k: int = 10):
        by = defaultdict(int)
        for s, e, n in self.device:
            by[n[:120]] += e - s
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda r: -r[1])[:k]]

    def gaps(self):
        """(start, end) of each stretch of the window with no device work."""
        out, cur = [], self.t0
        for s, e in self.busy:
            if s > cur:
                out.append((cur, min(s, self.t1)))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return [(s, e) for s, e in out if e > s]

    def idle_gaps(self, k: int = 10):
        """Idle device time summed by the innermost host operation running
        at each gap's midpoint ("python" where none is), over the
        ``GAPS_ATTRIBUTED`` longest gaps; the ``k`` largest sums."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = defaultdict(int)
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:GAPS_ATTRIBUTED]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "python"
            for j in range(i, max(-1, i - 4000), -1):      # latest start that covers mid
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            by[name[:120]] += e - s
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda r: -r[1])[:k]]
