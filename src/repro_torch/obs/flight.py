"""Persistent NVMM flight recorder — the engine's black box.

The VERSION-5 layout carves ``policy.flight_records`` fixed 64-byte
(one cacheline) record slots between the route table and the paged
region (``policy.flight_base``).  Writers append state-transition events
round-robin; after a crash, :func:`decode_ring` rebuilds the surviving
timeline so every torn state comes with the engine's last ~1k actions
(``RecoveryStats.flight_events``, ``python -m repro.obs.dump``).

Record format (``<IHHQQQQQQ``, 56 bytes used, zero-padded to 64)::

    u32 crc      crc32 over bytes [4:56] of the record
    u16 type     EV_* (below)
    u16 flags    reserved, 0
    u64 eseq     monotonic event sequence (never reused; orders the ring
                 across wraparound laps)
    u64 t_ns     time.monotonic_ns() at record time
    u64 a,b,c,d  event-specific payload (see EV_FIELDS)

Persistence protocol: slot store + ``pwb`` only — **no fence**.  The
engine fences constantly (every group commit ends in ``psync``), so
flight lines piggyback on the next engine fence instead of paying one
per event; the price is that the newest record(s) may be torn or lost
at a crash.  That is the right trade for a black box: the decoder
CRC-validates every slot, drops torn tails, and orders survivors by
``eseq`` (strictly increasing == seq-consistent).  The ring lives below
``page_base``, so ``repro.analysis.pmcheck`` can never mistake a flight
store for a log/frame/route commit point, and the missing fence is
invisible to PM001/PM002 because flight slots are never inside a commit
window's covered range.
"""
from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core import locking

FLIGHT_REC = 64
_REC = struct.Struct("<IHHQQQQQQ")

_U64_MASK = (1 << 64) - 1


def _u64(v) -> int:
    return 0 if v is None else int(v) & _U64_MASK

EV_ATTACH = 1            # a=obs_level, b=shards, c=flight_records
EV_COMMIT = 2            # a=sid, b=group head seq, c=head entry idx, d=k
EV_BATCH = 3             # a=sid, b=start idx, c=entries drained
EV_BARRIER_ENTER = 4     # a=fdid, b=shards drained behind the barrier
EV_BARRIER_EXIT = 5      # a=fdid
EV_BACKPRESSURE = 6      # a=sid, b=wait_ns
EV_MODE_MIGRATE = 7      # a=fdid, b=1 to paged / 0 to log
EV_ROUTE_EPOCH = 8       # a=fdid, b=new sid, c=new stripe shift (0: move)
EV_META_OP = 9           # a=mop code, b=fdid, c=seq

EV_NAMES = {
    EV_ATTACH: "attach",
    EV_COMMIT: "commit",
    EV_BATCH: "drain_batch",
    EV_BARRIER_ENTER: "barrier_enter",
    EV_BARRIER_EXIT: "barrier_exit",
    EV_BACKPRESSURE: "backpressure",
    EV_MODE_MIGRATE: "mode_migrate",
    EV_ROUTE_EPOCH: "route_epoch",
    EV_META_OP: "meta_op",
}

EV_FIELDS = {
    EV_ATTACH: ("obs_level", "shards", "flight_records", ""),
    EV_COMMIT: ("sid", "seq", "head", "k"),
    EV_BATCH: ("sid", "start", "entries", ""),
    EV_BARRIER_ENTER: ("fdid", "shards", "", ""),
    EV_BARRIER_EXIT: ("fdid", "", "", ""),
    EV_BACKPRESSURE: ("sid", "wait_ns", "", ""),
    EV_MODE_MIGRATE: ("fdid", "to_paged", "", ""),
    EV_ROUTE_EPOCH: ("fdid", "new_sid", "new_shift", ""),
    EV_META_OP: ("op", "fdid", "seq", ""),
}


@dataclass
class FlightEvent:
    eseq: int
    t_ns: int
    type: int
    a: int
    b: int
    c: int
    d: int

    @property
    def name(self) -> str:
        return EV_NAMES.get(self.type, f"ev{self.type}")

    def format_line(self, t0_ns: Optional[int] = None) -> str:
        dt = "" if t0_ns is None else f" +{(self.t_ns - t0_ns) / 1e6:.3f}ms"
        fields = EV_FIELDS.get(self.type, ("a", "b", "c", "d"))
        kv = " ".join(f"{k}={v}" for k, v in
                      zip(fields, (self.a, self.b, self.c, self.d)) if k)
        return f"#{self.eseq:<6}{dt:>12}  {self.name:<14} {kv}"


class FlightRecorder:
    """Round-robin writer over the NVMM flight ring.

    One ``leaf:flight`` lock serializes slot allocation — events are
    rare relative to ops (state transitions, one commit record per
    *group*, not per write), so a plain lock beats a CAS loop here and
    keeps ``eseq`` dense.  Safe to call while holding any lock up to the
    leaf band (the flight lock is a level-90 leaf).
    """

    GUARDED_BY = {
        "_eseq": "_lock",
    }

    def __init__(self, nvmm, policy, registry=None):
        self.nvmm = nvmm
        self.base = policy.flight_base
        self.nrec = policy.flight_records
        self._lock = locking.make_lock("leaf:flight")
        # Continue after the highest surviving eseq so an adopt without
        # a reformat keeps the ring ordering monotonic.
        events, _ = decode_ring(nvmm, policy)
        self._eseq = events[-1].eseq if events else 0
        self.events_total = None
        if registry is not None:
            self.events_total = registry.counter("flight.event_total")

    def record(self, ev_type: int, a: int = 0, b: int = 0, c: int = 0,
               d: int = 0) -> None:
        if self.nrec <= 0:
            return
        t_ns = time.monotonic_ns()
        with self._lock:
            self._eseq += 1
            eseq = self._eseq
        # payloads are descriptive, not load-bearing: clamp None and
        # negative sentinels (e.g. a width migration's new_sid) into u64
        a, b, c, d = (_u64(a), _u64(b), _u64(c), _u64(d))
        body = _REC.pack(0, ev_type, 0, eseq, t_ns, a, b, c, d)
        crc = zlib.crc32(body[4:])
        rec = struct.pack("<I", crc) + body[4:]
        off = self.base + ((eseq - 1) % self.nrec) * FLIGHT_REC
        self.nvmm.store(off, rec)
        self.nvmm.pwb(off, FLIGHT_REC)
        if self.events_total is not None:
            self.events_total.inc()


def decode_ring(nvmm, policy,
                durable: bool = False) -> Tuple[List[FlightEvent], int]:
    """Decode surviving flight records, ordered by ``eseq``.

    Returns ``(events, dropped)`` where ``dropped`` counts non-empty
    slots that failed CRC (torn tail records, or half-written slots from
    a crash mid-store).  ``durable=True`` reads the durable NVMM shadow
    (what survived the crash) instead of the volatile buffer.
    """
    base, nrec = policy.flight_base, policy.flight_records
    events: List[FlightEvent] = []
    dropped = 0
    read = nvmm.load_durable if durable and hasattr(nvmm, "load_durable") \
        else nvmm.load
    for i in range(nrec):
        raw = bytes(read(base + i * FLIGHT_REC, FLIGHT_REC))
        if raw[:_REC.size].count(0) == _REC.size:
            continue                      # never-written slot
        crc, ev_type, _flags, eseq, t_ns, a, b, c, d = \
            _REC.unpack_from(raw)
        if eseq == 0 or zlib.crc32(raw[4:_REC.size]) != crc:
            dropped += 1
            continue
        events.append(FlightEvent(eseq, t_ns, ev_type, a, b, c, d))
    events.sort(key=lambda e: e.eseq)
    return events, dropped


def format_timeline(events: List[FlightEvent], dropped: int = 0) -> str:
    if not events:
        return (f"flight recorder: empty ring"
                f"{f' ({dropped} torn record(s) dropped)' if dropped else ''}")
    t0 = events[0].t_ns
    lines = [f"flight recorder: {len(events)} event(s), "
             f"eseq {events[0].eseq}..{events[-1].eseq}"
             + (f", {dropped} torn record(s) dropped" if dropped else "")]
    lines.extend(e.format_line(t0) for e in events)
    return "\n".join(lines)
