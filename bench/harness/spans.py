"""The program's own ranges in a traced window: the ``record_function``
ranges that ``repro_torch/runtime/ranges.py`` opens at the program's layer
boundaries, read from the host events of ``trace.Trace`` (the profiler's
clock, which the device's events share).  Gives the ranges of one name in
the window, the device's idle time inside a set of intervals (and as a
share of a name's ranges) and the host events that start inside them."""
from __future__ import annotations

import bisect

from bench.harness.trace import _union

# the host-side CUDA calls that start device work: a kernel launch, a copy, a
# set, or a CUDA graph's replay (one call, whatever the graph holds)
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                      "cudaGraphLaunch"})


def named(trace, name: str) -> list:
    """(start, end) ns of every host event called ``name``, clipped to the
    window [t0, t1] and sorted; one wholly outside it is left out."""
    out = []
    for s, e, n in trace.host:
        if n == name:
            s, e = max(s, trace.t0), min(e, trace.t1)
            if e > s:
                out.append((s, e))
    return sorted(out)


def total_ns(intervals) -> int:
    """The ns the intervals cover (overlaps once)."""
    return sum(e - s for s, e in _union(intervals))


def idle_ns(trace, intervals) -> int:
    """The ns of ``intervals`` in which the device runs nothing: their
    overlap with the window's gaps (``Trace.gaps``)."""
    a, b = _union(intervals), trace.gaps()
    i = j = out = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_pct(trace, name: str):
    """The share of the window's ``name`` ranges in which the device runs
    nothing, in percent; None where the window holds none of them."""
    ranges = named(trace, name)
    return 100.0 * idle_ns(trace, ranges) / total_ns(ranges) if ranges else None


def starting_in(trace, intervals, names) -> int:
    """How many host events called one of ``names`` start inside one of
    ``intervals`` (each taken as [start, end))."""
    iv = _union(intervals)
    starts = [s for s, _ in iv]
    count = 0
    for s, _, n in trace.host:
        if n in names:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < iv[i][1]:
                count += 1
    return count
