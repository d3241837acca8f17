"""Simulated byte-addressable NVMM with an explicit crash model.

The paper's prototype runs on Optane NVDIMMs and orders durability with
three primitives (§III):

  * ``pwb(addr)``  — enqueue the cacheline holding ``addr`` for flushing
                     (``clwb`` on x86),
  * ``pfence()``   — order: every ``pwb`` issued before the fence completes
                     before any store issued after it (``sfence``),
  * ``psync()``    — like ``pfence`` but additionally guarantees the lines
                     have reached the persistence domain.

This container has no NVMM, so we simulate the *semantics*: a volatile
"CPU cache" view (what loads observe) plus a durable shadow (what survives
``crash()``).  The shadow is tracked at cacheline granularity which makes
the log's commit protocol *testable*: hypothesis can crash at any point and
choose which un-flushed dirty lines happened to be evicted to media, so a
missing ``pwb``/``pfence`` in the protocol becomes a failing property test.

Crash model (standard persistent-memory testing model, e.g. Yat):
  * a store makes its line *dirty*;
  * ``pwb`` marks the line *flush-requested*;
  * ``pfence``/``psync`` drain every flush-requested line to the durable
    shadow (guaranteed durable from then on);
  * at ``crash()``, every remaining dirty line independently may or may not
    have been evicted to media (the test chooses adversarially); we expose
    the choice via a callback.

``track=False`` disables the shadow entirely (used by benchmarks where only
the volatile view matters for throughput).

Region map (layout VERSION 5, offsets computed by
:class:`repro.core.policy.Policy`)::

    0             superblock (magic/version/geometry) + per-shard
                  persistent tails (one cacheline each, from SHARD_TAILS)
    SUPERBLOCK    fd-path table (fd_max slots of path_max bytes)
    route_base    persisted route record (epoch + overrides + stripe-width
                  tuning entries, CRC'd header)
    flight_base   flight-recorder ring (VERSION 5): flight_records 64-byte
                  CRC'd event records, round-robin, store+pwb only (no
                  fence — lines ride the engine's next psync) — see
                  :mod:`repro.obs.flight`
    page_base     paged region (VERSION 4): page_frames in-place frames,
                  each [header cacheline | 2 ping-pong page slots] — see
                  :mod:`repro.core.pager`
    entries_base  K shard logs of entries_per_shard fixed-size entries

VERSION 4 is the same map minus the ``flight_base`` row (and with an
8-field superblock): a VERSION-4 image with ``flight_records=0`` decodes
identically under VERSION 5 offsets.

Two persistence modes share the region: log shards (append + drain) and
paged frames (in-place overwrite + writeback).  They are seq-fenced
against each other — both draw commit seqs from one global counter, and
recovery replays their union in ascending seq — and a given (file, page)
is owned by exactly one mode at a time (see :mod:`repro.core.log`).
"""
from __future__ import annotations

import struct
from typing import Callable, Iterable, Optional

from repro_torch.core.policy import CACHELINE

_U64 = struct.Struct("<Q")


class NVMM:
    """One simulated NVMM region (a DAX device or DAX file in the paper)."""

    def __init__(self, size: int, *, track: bool = False):
        self.size = size
        self.track = track
        self._buf = bytearray(size)          # CPU-visible content
        self._durable: Optional[bytearray] = bytearray(size) if track else None
        self._dirty: set[int] = set()        # dirty line indices
        self._requested: set[int] = set()    # pwb'd but not yet fenced
        self.stats_pwb = 0
        self.stats_pwb_lines = 0             # cachelines covered by pwb calls
        self.stats_fence = 0
        self.stats_psync = 0
        self.stats_stored_bytes = 0

    # -- volatile (CPU cache) accessors ------------------------------------
    def store(self, off: int, data: bytes | bytearray | memoryview) -> None:
        n = len(data)
        self._buf[off:off + n] = data
        self.stats_stored_bytes += n
        if self.track:
            self._dirty.update(range(off // CACHELINE, (off + n - 1) // CACHELINE + 1))

    def load(self, off: int, n: int) -> memoryview:
        return memoryview(self._buf)[off:off + n]

    def store_u64(self, off: int, val: int) -> None:
        self.store(off, _U64.pack(val))

    def load_u64(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    # -- persistence primitives (paper §III) --------------------------------
    def pwb(self, off: int, n: int = CACHELINE) -> None:
        """Request flush of the cachelines covering ``[off, off+n)``."""
        self.stats_pwb += 1
        self.stats_pwb_lines += \
            (off + max(n, 1) - 1) // CACHELINE - off // CACHELINE + 1
        if self.track:
            lines = range(off // CACHELINE, (off + n - 1) // CACHELINE + 1)
            self._requested.update(l for l in lines if l in self._dirty)

    def pfence(self) -> None:
        """Drain flush-requested lines; order them before subsequent stores."""
        self.stats_fence += 1
        self._drain_requested()

    def psync(self) -> None:
        """Like ``pfence`` but guarantees arrival in the persistence domain."""
        self.stats_psync += 1
        self._drain_requested()

    def _drain_requested(self) -> None:
        if not self.track:
            return
        # pop-drain rather than iterate: concurrent pwb() calls (writer vs
        # cleanup threads share the region) mutate the set mid-fence, and
        # iterating a set while another thread updates it raises.  Draining
        # a line requested *during* the fence is benign — fences guarantee
        # at-least the lines requested before them.
        while self._requested:
            try:
                line = self._requested.pop()
            except KeyError:
                break
            b = line * CACHELINE
            e = min(b + CACHELINE, self.size)
            self._durable[b:e] = self._buf[b:e]
            self._dirty.discard(line)

    # -- crash simulation ----------------------------------------------------
    def crash(self, choose_evicted: Optional[Callable[[Iterable[int]], Iterable[int]]] = None) -> None:
        """Simulate power loss.

        ``choose_evicted`` receives the sorted dirty-line indices and returns
        the subset that happened to reach media before the crash (hardware may
        evict any dirty line at any time).  Default: none of them made it —
        the most common adversarial case for a write-ahead protocol.
        After the call, the volatile view equals the durable state.
        """
        if not self.track:
            raise RuntimeError("crash() requires track=True")
        pending = sorted(self._dirty | self._requested)
        evicted = set(choose_evicted(pending)) if choose_evicted else set()
        for line in evicted:
            b = line * CACHELINE
            e = min(b + CACHELINE, self.size)
            self._durable[b:e] = self._buf[b:e]
        self._buf[:] = self._durable
        self._dirty.clear()
        self._requested.clear()

    # convenience for protocol code: store+flush in one call (NOT one atomic
    # op — still two steps, kept separate in the log protocol where ordering
    # matters).
    def store_flush(self, off: int, data: bytes) -> None:
        self.store(off, data)
        self.pwb(off, len(data))
