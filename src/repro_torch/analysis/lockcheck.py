"""Runtime lock-order recorder for the hierarchy in ``repro.core.locking``.

When installed (``pytest --sanitize``), :class:`LockTracer` becomes the
factory behind ``locking.make_lock``/``make_rlock``/``make_condition``:
every registered lock is wrapped in a :class:`TracedLock` that maintains
a per-thread stack of held locks, checks the hierarchy on every
*blocking* acquisition, and accumulates a global class-level acquisition
graph for deadlock (cycle) detection.

Error codes (collected in :attr:`LockTracer.violations`):

* ``LC001`` — blocking acquisition of an ordered lock whose level is not
  strictly above the highest ordered level already held (a hierarchy
  inversion: two threads doing this in opposite orders deadlock).
* ``LC002`` — same-class stacking of a ``multi`` class with a
  non-increasing order key (page locks must be taken in ascending page
  order).
* ``LC003`` — a cycle in the class-level acquisition graph, reported by
  :meth:`LockTracer.check_cycles` at detach (a potential deadlock even
  if no run ever interleaved into it).
* ``LC004`` — backend I/O (``pwrite``/``pwritev``/``fsync``) issued while
  holding a shard alloc lock: the device round-trip would serialize every
  writer behind it.

Non-blocking (try-lock) acquisitions are exempt from LC001/LC002 and do
not feed the cycle graph — they cannot deadlock — but a successful one
still counts as held for LC004.

Violations are :class:`repro.analysis.trace.Violation` records,
deduplicated by (code, lock classes, site) so a sweep reports each
distinct pattern once.

When a :class:`repro.analysis.racecheck.RaceCheck` is attached
(``tracer.race``), every acquire/release of a TracedLock is forwarded to
it — the happens-before edges of the vector-clock analysis — and the
tracer's per-thread held stack doubles as the lockset.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.trace import Reporter, tid, tname
from repro_torch.core.locking import LEAF_LEVEL


class TracedLock:
    """Hierarchy-aware wrapper around ``threading.Lock``/``RLock``."""

    def __init__(self, tracer: "LockTracer", name: str, level: int,
                 multi: bool, order_key=None, group=None, rlock: bool = False):
        self._tracer = tracer
        self.name = name
        self.level = level
        self.multi = multi
        self.order_key = order_key
        self.group = group
        self._rlock = rlock
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = tid()
        if self._rlock and self._owner == me:
            self._inner.acquire(blocking, timeout)
            self._count += 1
            return True
        if blocking:
            self._tracer.before_blocking_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            self._tracer.note_acquired(self)
        return ok

    def release(self) -> None:
        if self._rlock and self._count > 1:
            self._count -= 1
            self._inner.release()
            return
        self._owner = None
        self._count = 0
        self._tracer.note_released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        if self._rlock:
            return self._owner is not None
        return self._inner.locked()

    # ``threading.Condition`` protocol.  Without ``_is_owned`` the stdlib
    # falls back to probing ``acquire(False)`` — which *succeeds* reentrantly
    # on an RLock-backed wrapper, so notify() would wrongly conclude the
    # lock is un-owned and raise.
    def _is_owned(self) -> bool:
        return self._owner == tid()

    def _release_save(self):
        count = self._count if self._rlock else 1
        self._owner = None
        self._count = 0
        self._tracer.note_released(self)
        for _ in range(count):
            self._inner.release()
        return count

    def _acquire_restore(self, count) -> None:
        for _ in range(count):
            self._inner.acquire()
        self._owner = tid()
        self._count = count
        self._tracer.note_acquired(self)

    def __repr__(self) -> str:
        key = f", key={self.order_key}" if self.order_key is not None else ""
        return f"<TracedLock {self.name}@{self.level}{key}>"


class LockTracer:
    """Global recorder shared by every TracedLock of a sanitized run."""

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._rep = Reporter()
        self.violations = self._rep.violations
        self.edges: Dict[Tuple[str, str], str] = {}
        self.stats_acquisitions = 0
        self.race = None                  # optional RaceCheck (HB edges)

    # factory used by repro.core.locking
    def traced_lock(self, name: str, info: dict, order_key=None, group=None,
                    rlock: bool = False) -> TracedLock:
        return TracedLock(self, name, info["level"], info["multi"],
                          order_key=order_key, group=group, rlock=rlock)

    # ------------------------------------------------------------ held state
    def _held(self) -> List[TracedLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_locks(self) -> List[TracedLock]:
        """The calling thread's current lockset (racecheck reads this)."""
        return self._held()

    def _flag(self, code: str, key: Tuple, msg: str) -> None:
        self._rep.flag(code, msg, key=(code,) + key)

    # --------------------------------------------------------------- checks
    def before_blocking_acquire(self, lock: TracedLock) -> None:
        held = self._held()
        if not held:
            return
        me = tname()
        with self._mu:
            for h in held:
                if h.name != lock.name or not lock.multi:
                    self.edges.setdefault((h.name, lock.name), me)
        if lock.level >= LEAF_LEVEL:
            return                        # leaves: edges only, no level rule
        ordered = [h for h in held if h.level < LEAF_LEVEL]
        if not ordered:
            return
        top = max(ordered, key=lambda h: h.level)
        if lock.level > top.level:
            return
        if lock.level == top.level and lock.multi and lock.name == top.name:
            same = [h for h in ordered
                    if h.name == lock.name and h.group == lock.group]
            if same and lock.order_key is not None:
                prev = same[-1].order_key
                if prev is not None and not (lock.order_key > prev):
                    self._flag("LC002", (lock.name, me),
                               f"[{me}] {lock.name} stacked with "
                               f"non-increasing order key {lock.order_key!r} "
                               f"after {prev!r}")
            return
        self._flag("LC001", (lock.name, top.name, me),
                   f"[{me}] blocking acquire of {lock!r} while holding "
                   f"{top!r} (levels must strictly increase; held: "
                   f"{[h.name for h in held]})")

    def note_acquired(self, lock: TracedLock) -> None:
        self._held().append(lock)
        self.stats_acquisitions += 1
        if self.race is not None:
            self.race.on_acquire(lock)

    def note_released(self, lock: TracedLock) -> None:
        if self.race is not None:
            self.race.on_release(lock)
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    # ---------------------------------------------------------- backend I/O
    def on_backend_io(self, kind: str, detail: str = "") -> None:
        held = [h.name for h in self._held()]
        if "shard" in held:
            me = tname()
            self._flag("LC004", (kind, me),
                       f"[{me}] backend {kind} {detail} issued while "
                       f"holding a shard alloc lock (held: {held})")

    # --------------------------------------------------------------- cycles
    def check_cycles(self) -> List[str]:
        """DFS the class-level acquisition graph; a cycle is a potential
        deadlock even if no run ever interleaved into it."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            if a != b:
                adj.setdefault(a, set()).add(b)
        found: List[str] = []
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in adj}

        def dfs(n: str, path: List[str]) -> None:
            color[n] = GRAY
            path.append(n)
            for m in adj.get(n, ()):
                if color.get(m, WHITE) == GRAY:
                    cyc = path[path.index(m):] + [m]
                    found.append(" -> ".join(cyc))
                elif color.get(m, WHITE) == WHITE:
                    color.setdefault(m, WHITE)
                    dfs(m, path)
            path.pop()
            color[n] = BLACK

        for n in list(adj):
            if color.get(n, WHITE) == WHITE:
                dfs(n, [])
        for cyc in found:
            self._flag("LC003", (cyc,), f"acquisition-order cycle: {cyc}")
        return found

    def summary(self) -> dict:
        return {
            "violations": [str(v) for v in self.violations],
            "acquisitions": self.stats_acquisitions,
            "edges": sorted(f"{a}->{b}" for a, b in self.edges),
        }
