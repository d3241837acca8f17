"""Observability plane: metrics registry, span profiler, flight recorder.

Three layers, one bundle (:class:`ObsPlane`), wired into ``NVCache`` at
construction and threaded through the log shards and the drain pool:

* :mod:`repro.obs.metrics` — typed ``Counter``/``Gauge``/``Histogram``
  behind per-thread shards merged on read; no hot-path locks.
* :mod:`repro.obs.spans` — timed spans over the write pipeline, the
  read-miss path and the drain/barrier stalls, gated by
  ``Policy.obs_level`` so level 0 costs a branch per op.
* :mod:`repro.obs.flight` — a CRC'd ring of fixed-size event records
  carved into the NVMM layout (VERSION 5): the engine's black box,
  decoded into a forensic timeline by ``core/recovery.py`` after a
  crash (``python -m repro.obs.dump``).

See ``src/repro/obs/README.md`` for the metric naming grammar, the span
taxonomy and the flight-record format.
"""
from __future__ import annotations

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (BoundGauge, Counter, Gauge, Histogram,
                               Registry)
from repro_torch.obs.spans import SpanProfiler


class ObsPlane:
    """Per-engine observability bundle: one registry, one span profiler,
    one flight recorder (when the layout carves a ring).

    Created once in ``NVCache.__init__`` before any worker thread starts
    and published read-only after that — every field here is set exactly
    once and never rebound, so cross-thread visibility rides on the
    thread-start happens-before edge.
    """

    def __init__(self, policy, nvmm=None):
        self.level = policy.obs_level
        self.registry = Registry()
        self.prof = SpanProfiler(self.registry, self.level)
        self.flight = None
        if nvmm is not None and policy.flight_records:
            self.flight = FlightRecorder(nvmm, policy,
                                         registry=self.registry)


__all__ = ["ObsPlane", "Registry", "Counter", "Gauge", "Histogram",
           "BoundGauge", "SpanProfiler", "FlightRecorder"]
