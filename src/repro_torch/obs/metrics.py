"""Typed metrics behind per-thread shards — no locks on the hot path.

Naming grammar (statically checked by lint L006, dynamically on
``register``): ``subsystem.noun_unit`` where ``subsystem`` and ``noun``
are snake_case and ``unit`` is one of ``total`` (monotonic count),
``count`` (instantaneous count), ``bytes``, ``us``, ``s``, ``ratio``.
Examples: ``nvmm.pwb_total``, ``log.alloc_wait_us``, ``route.skew_ratio``.

Concurrency design: each :class:`Counter`/:class:`Histogram` keeps one
private *cell* per touching thread (``threading.local``).  The hot path
mutates only the calling thread's own cell — plain ``+=`` on attributes
of an object no other thread writes, so there is no lock, no CAS and no
false sharing.  The cold paths (first touch from a new thread, and
``snapshot``/merge on read) take the metric's ``leaf:obs`` lock to
append to / walk the cell list.  Readers sum other threads' cells
without a lock: Python's GIL makes each individual load atomic and the
sums are statistically consistent snapshots, which is all a metrics
plane promises.  The cell objects themselves deliberately declare no
``GUARDED_BY`` table — they are single-writer by construction and the
racecheck shadow would cost exactly the hot-path overhead this design
exists to avoid.

Histograms use fixed log2 nanosecond buckets: bucket ``i`` holds values
``v`` with ``v.bit_length() == i``, i.e. ``[2^(i-1), 2^i)`` (bucket 0 is
the value 0).  Percentiles interpolate linearly inside the bucket and
clamp to the observed min/max, so ``p50/p95/p99/p999`` are exact to
bucket resolution and exact at the distribution edges.
"""
from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core import locking

_UNITS = ("total", "count", "bytes", "us", "s", "ratio")
NAME_RE = re.compile(
    r"^[a-z][a-z0-9]*\.[a-z][a-z0-9_]*_(?:%s)$" % "|".join(_UNITS))

_N_BUCKETS = 64                    # covers 0 .. 2^63-1 ns (~292 years)


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the subsystem.noun_unit "
            f"grammar (units: {', '.join(_UNITS)})")
    return name


def _scale_for(name: str) -> float:
    """ns -> reported-unit factor implied by the name's unit suffix."""
    if name.endswith("_us"):
        return 1e-3
    if name.endswith("_s"):
        return 1e-9
    return 1.0


class _CounterCell:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0


class _HistCell:
    __slots__ = ("buckets", "count", "sum", "vmin", "vmax")

    def __init__(self):
        self.buckets = [0] * _N_BUCKETS
        self.count = 0
        self.sum = 0
        self.vmin = None
        self.vmax = 0


class _Sharded:
    """Base for per-thread-cell metrics: cell discovery + registration."""

    GUARDED_BY = {
        # Appended on a thread's first touch, walked by snapshot readers;
        # the cells' *contents* are single-writer (see module docstring).
        "_cells": "_lock",
    }

    _CELL = _CounterCell

    def __init__(self, name: str):
        self.name = check_name(name)
        self._lock = locking.make_lock("leaf:obs")
        self._cells: List[object] = []
        self._tl = threading.local()

    def _cell(self):
        tl = self._tl
        try:
            return tl.cell
        except AttributeError:
            cell = self._CELL()
            with self._lock:
                self._cells.append(cell)
            tl.cell = cell
            return cell

    def _all_cells(self) -> List[object]:
        with self._lock:
            return list(self._cells)


class Counter(_Sharded):
    """Monotonic counter; ``inc`` is lock-free on the calling thread's
    private cell."""

    kind = "counter"

    def inc(self, n: int = 1) -> None:
        self._cell().n += n

    @property
    def value(self) -> int:
        return sum(c.n for c in self._all_cells())

    def read(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value.  A single GIL-atomic slot —
    gauges are set from one place at a time (no read-modify-write), so a
    shard split buys nothing."""

    kind = "gauge"

    GUARDED_BY = {
        # Single plain slot: every set is one STORE_ATTR, every read one
        # LOAD_ATTR; last-write-wins is the gauge contract.
        "_value": locking.VOLATILE,
    }

    def __init__(self, name: str):
        self.name = check_name(name)
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self._value

    def read(self):
        return self._value


class BoundGauge:
    """Gauge computed on read from a callback — the adapter that lets
    pre-existing plain counters (``nvmm.stats_pwb`` et al.) surface in
    the registry without being rewritten."""

    kind = "bound"

    def __init__(self, name: str, fn: Callable[[], object]):
        self.name = check_name(name)
        self._fn = fn

    @property
    def value(self):
        return self._fn()

    def read(self):
        return self._fn()


class Histogram(_Sharded):
    """Fixed log2-ns-bucket latency histogram with per-thread cells.

    ``record_ns`` is the only hot-path entry point; everything else
    merges cells on read.  All derived statistics are zero-count safe
    (``mean``/``percentile`` return 0.0 on an empty histogram).
    """

    kind = "histogram"
    _CELL = _HistCell

    def record_ns(self, ns: int) -> None:
        if ns < 0:
            ns = 0
        c = self._cell()
        i = ns.bit_length()
        if i >= _N_BUCKETS:
            i = _N_BUCKETS - 1
        c.buckets[i] += 1
        c.count += 1
        c.sum += ns
        if c.vmin is None or ns < c.vmin:
            c.vmin = ns
        if ns > c.vmax:
            c.vmax = ns

    # ------------------------------------------------------------- reads

    def _merged(self):
        buckets = [0] * _N_BUCKETS
        count = 0
        total = 0
        vmin = None
        vmax = 0
        for c in self._all_cells():
            cb = c.buckets
            for i in range(_N_BUCKETS):
                buckets[i] += cb[i]
            count += c.count
            total += c.sum
            if c.vmin is not None and (vmin is None or c.vmin < vmin):
                vmin = c.vmin
            if c.vmax > vmax:
                vmax = c.vmax
        return buckets, count, total, (vmin or 0), vmax

    @property
    def count(self) -> int:
        return sum(c.count for c in self._all_cells())

    @property
    def sum_ns(self) -> int:
        return sum(c.sum for c in self._all_cells())

    @property
    def sum_s(self) -> float:
        return self.sum_ns * 1e-9

    def mean_ns(self) -> float:
        n = 0
        s = 0
        for c in self._all_cells():
            n += c.count
            s += c.sum
        return s / n if n else 0.0

    def percentile_ns(self, q: float) -> float:
        """q in [0, 1].  Linear interpolation inside the log2 bucket,
        clamped to observed min/max.  0.0 when empty."""
        buckets, count, _total, vmin, vmax = self._merged()
        return _percentile(buckets, count, vmin, vmax, q)

    def snapshot(self) -> Dict[str, object]:
        return _hist_snapshot(self.name, *self._merged())

    def read(self):
        return self.snapshot()

    @staticmethod
    def merged_snapshot(name: str,
                        hists: Iterable["Histogram"]) -> Dict[str, object]:
        """One snapshot over several histograms' pooled buckets (e.g. the
        per-shard alloc-wait histograms reported as one metric)."""
        buckets = [0] * _N_BUCKETS
        count = 0
        total = 0
        vmin = None
        vmax = 0
        for h in hists:
            b, n, s, lo, hi = h._merged()
            for i in range(_N_BUCKETS):
                buckets[i] += b[i]
            count += n
            total += s
            if n and (vmin is None or lo < vmin):
                vmin = lo
            if hi > vmax:
                vmax = hi
        return _hist_snapshot(name, buckets, count, total, (vmin or 0),
                              vmax)


def _percentile(buckets, count, vmin, vmax, q) -> float:
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0.0
    for i, n in enumerate(buckets):
        if n == 0:
            continue
        if cum + n >= target:
            lo = 0 if i == 0 else 1 << (i - 1)
            hi = 1 if i == 0 else 1 << i
            frac = (target - cum) / n
            v = lo + (hi - lo) * frac
            return float(min(max(v, vmin), vmax))
        cum += n
    return float(vmax)


def _hist_snapshot(name, buckets, count, total, vmin, vmax):
    scale = _scale_for(name)
    unit = name.rsplit("_", 1)[-1]

    def cv(ns):
        return ns * scale

    return {
        "count": count,
        f"sum_{unit}": cv(total),
        f"mean_{unit}": cv(total / count) if count else 0.0,
        f"min_{unit}": cv(vmin if count else 0),
        f"max_{unit}": cv(vmax),
        f"p50_{unit}": cv(_percentile(buckets, count, vmin, vmax, 0.50)),
        f"p95_{unit}": cv(_percentile(buckets, count, vmin, vmax, 0.95)),
        f"p99_{unit}": cv(_percentile(buckets, count, vmin, vmax, 0.99)),
        f"p999_{unit}": cv(_percentile(buckets, count, vmin, vmax, 0.999)),
    }


class Registry:
    """Name -> metric table plus read-time bindings over legacy counters.

    Registration happens at engine construction (single-threaded); reads
    happen from ``api.stats()`` and the ``--profile`` report.  Both are
    cold, so one plain lock covers the table.
    """

    GUARDED_BY = {
        "_metrics": "_lock",
        "_groups": "_lock",
        "_summaries": "_lock",
    }

    def __init__(self):
        self._lock = locking.make_lock("leaf:obs")
        self._metrics: Dict[str, object] = {}
        self._groups: List[tuple] = []       # (name->key map, fn)
        self._summaries: List[tuple] = []    # (name, fn -> dict)

    def _adopt(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name!r} already "
                                 f"registered")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str) -> Counter:
        return self._adopt(Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._adopt(Gauge(name))

    def histogram(self, name: str) -> Histogram:
        return self._adopt(Histogram(name))

    def bind(self, name: str, fn: Callable[[], object]) -> BoundGauge:
        return self._adopt(BoundGauge(name, fn))

    def bind_group(self, names: Dict[str, str],
                   fn: Callable[[], dict]) -> None:
        """One callback returning a dict, fanned out to several metric
        names (``{metric_name: dict_key}``) — preserves the coherence of
        subsystems that already snapshot under one lock."""
        for n in names:
            check_name(n)
        with self._lock:
            for n in names:
                if n in self._metrics:
                    raise ValueError(f"metric {n!r} already registered")
                self._metrics[n] = None      # reserve the name
            self._groups.append((dict(names), fn))

    def bind_summary(self, name: str, fn: Callable[[], dict]) -> None:
        """A callback producing a full histogram-style snapshot dict
        under one name (e.g. per-shard histograms pooled on read)."""
        check_name(name)
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = None       # reserve the name
            self._summaries.append((name, fn))

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            metrics = [m for m in self._metrics.values() if m is not None]
            groups = list(self._groups)
            summaries = list(self._summaries)
        out: Dict[str, object] = {}
        for m in metrics:
            out[m.name] = m.read()
        for names, fn in groups:
            d = fn()
            for name, key in names.items():
                out[name] = d.get(key, 0)
        for name, fn in summaries:
            out[name] = fn()
        return out
