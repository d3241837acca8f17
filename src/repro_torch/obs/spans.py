"""Write/read/drain pipeline span profiler, gated by ``Policy.obs_level``.

Span taxonomy (each is one latency :class:`~repro.obs.metrics.Histogram`
in the engine registry; see ``obs/README.md``):

====================  =====  ==============================================
name                  level  covers
====================  =====  ==============================================
``write.op_us``         1    one ``pwrite`` call end to end (split, alloc,
                             fill, group commit)
``write.fill_us``       2    NVMM memcpy of followers+head plus the
                             payload ``pwb``/``pfence`` (libnvram's
                             "persist cost" term)
``write.commit_us``     2    commit-flag store + ``pwb`` + sealing
                             ``psync`` + group-commit wake
``read.load_us``        2    one backend extent fetch (``preadv`` +
                             frame/page install) on a read miss
``read.replay_us``      2    one dirty-page log replay under the
                             cleanup lock
``drain.wait_us``       2    drain thread blocked in ``wait_committed``
``drain.plan_us``       2    ``build_plan`` (merge + coalesce)
``drain.apply_us``      2    ``apply_plan`` (includes pwritev + replays)
``drain.pwritev_us``    2    one backend ``pwritev`` inside apply
``drain.fsync_us``      2    the per-file fsync-epoch loop of one batch
``stall.barrier_us``    1    one ``_drain_barrier`` (fsync, migration,
                             unlink) from enter to drained
``log.alloc_wait_us``   always  backpressure wait in ``LogShard.alloc``
                             (kept by the shard, pooled on read)
====================  =====  ==============================================

Levels: 0 = off (the hot path pays one attribute load + branch — no
allocation, no clock read); 1 = op-level spans + flight commit events;
2 = full per-stage breakdown.  Instrumentation sites follow the

    t0 = time.perf_counter_ns() if obs.lv2 else 0
    ...
    if obs.lv2:
        obs.prof.h_fill.record_ns(time.perf_counter_ns() - t0)

pattern rather than a context manager: entering a ``with`` block
allocates, and the whole point of level 0 is that ``pwrite`` allocates
nothing on behalf of observability.  The :class:`Span` context manager
exists for the cold paths (drain stages, barriers) where clarity beats
the nanoseconds, and it nests: each thread keeps a span stack so a
report can attribute child time.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

_LEVELS = {
    "write.op_us": 1,
    "stall.barrier_us": 1,
    "write.fill_us": 2,
    "write.commit_us": 2,
    "read.load_us": 2,
    "read.replay_us": 2,
    "drain.wait_us": 2,
    "drain.plan_us": 2,
    "drain.apply_us": 2,
    "drain.pwritev_us": 2,
    "drain.fsync_us": 2,
}

# Report rows are grouped by pipeline position, not alphabetically.
_REPORT_ORDER = [
    "write.op_us", "write.fill_us", "write.commit_us",
    "log.alloc_wait_us",
    "drain.wait_us", "drain.plan_us", "drain.apply_us",
    "drain.pwritev_us", "drain.fsync_us",
    "read.load_us", "read.replay_us",
    "stall.barrier_us",
]


class Span:
    """Nestable timed region.  Allocates — cold paths only."""

    __slots__ = ("_prof", "_hist", "_t0", "name")

    def __init__(self, prof: "SpanProfiler", name: str, hist):
        self._prof = prof
        self._hist = hist
        self.name = name
        self._t0 = 0

    def __enter__(self):
        self._prof._stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        stack = self._prof._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._hist is not None:
            self._hist.record_ns(ns)
        return False


class SpanProfiler:
    """The per-engine span surface.

    All fields are created once, before worker threads start, and read
    immutably after — publication rides the thread-start edge.  Hot
    paths read ``lv1``/``lv2`` (plain bools) and the pre-bound
    histogram attributes; nothing here takes a lock.
    """

    def __init__(self, registry, level: int):
        self.registry = registry
        self.level = int(level)
        self.lv1 = self.level >= 1
        self.lv2 = self.level >= 2
        self._tl = threading.local()
        # Histograms exist whenever their level is enabled; the
        # attribute is None otherwise so call sites can be gated on the
        # level bool alone.
        self.h_op = self._mk("write.op_us")
        self.h_fill = self._mk("write.fill_us")
        self.h_commit = self._mk("write.commit_us")
        self.h_read_load = self._mk("read.load_us")
        self.h_read_replay = self._mk("read.replay_us")
        self.h_drain_wait = self._mk("drain.wait_us")
        self.h_drain_plan = self._mk("drain.plan_us")
        self.h_drain_apply = self._mk("drain.apply_us")
        self.h_drain_pwritev = self._mk("drain.pwritev_us")
        self.h_drain_fsync = self._mk("drain.fsync_us")
        self.h_barrier = self._mk("stall.barrier_us")

    def _mk(self, name: str):
        if self.level < _LEVELS[name]:
            return None
        return self.registry.histogram(name)

    def _stack(self) -> List[Span]:
        try:
            return self._tl.stack
        except AttributeError:
            self._tl.stack = []
            return self._tl.stack

    def span(self, name: str) -> Span:
        """Cold-path context manager; a no-op span when the stage's
        level is disabled."""
        return Span(self, name, self.registry.get(name))

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # ------------------------------------------------------------ report

    def report(self, extra_hists=()) -> str:
        """The ``--profile`` text table: per-stage count and p50/p95/p99
        plus each stage's share of total recorded time."""
        snap = self.registry.snapshot()
        snaps = {}
        for name in _REPORT_ORDER:
            s = snap.get(name)
            if isinstance(s, dict) and "count" in s:
                snaps[name] = s
        for h in extra_hists:
            snaps[h.name] = h.snapshot()
        rows = [(n, s) for n, s in snaps.items() if s["count"]]
        if not rows:
            return "span profiler: no samples (obs_level=%d)" % self.level
        total_us = sum(s["sum_us"] for _, s in rows)
        out = [f"{'stage':<20}{'count':>9}{'p50_us':>10}{'p95_us':>10}"
               f"{'p99_us':>10}{'total_ms':>10}{'share':>8}"]
        for name, s in rows:
            out.append(
                f"{name:<20}{s['count']:>9}{s['p50_us']:>10.1f}"
                f"{s['p95_us']:>10.1f}{s['p99_us']:>10.1f}"
                f"{s['sum_us'] / 1e3:>10.2f}"
                f"{100.0 * s['sum_us'] / total_us:>7.1f}%")
        return "\n".join(out)
