"""Global lock hierarchy and the registered-lock factories.

Every ``threading.Lock``/``RLock``/``Condition`` constructed inside
``repro.core`` MUST come from :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` with a class name drawn from the table below —
``repro.analysis.lint`` enforces this statically, and
``repro.analysis.lockcheck`` uses the registration to trace acquisitions
at runtime under ``pytest --sanitize``.

LOCK HIERARCHY (parsed by repro.analysis.lint — keep the column format):

    level  class          multi  owner
    -----  -------------  -----  -----------------------------------------
    10     meta                  Namespace.lock — the "_meta" file-table
                                 lock (api.NVCache._meta aliases it)
    20     route_gate            File._route_cv — per-file route freeze
                                 gate (enter/exit/freeze protocol)
    30     page_atomic    multi  PageDesc.atomic_lock, ascending page_no
    40     page_cleanup   multi  PageDesc.cleanup_lock, ascending page_no
    50     shard                 LogShard._lock (+ the _space/_committed
                                 conditions sharing it)
    60     pager_free            PagedRegion.lock — paged-frame free list
    90     leaf:seq              NVLog._seq_lock
    90     leaf:ref              PageDesc.ref_lock
    90     leaf:size             File.size_lock
    90     leaf:drained          File._drained condition
    90     leaf:cursor           OpenFile.cursor_lock
    90     leaf:lru              LRUCache._lock
    90     leaf:radix            RadixTree._insert_lock
    90     leaf:router           EpochRouter._lock
    90     leaf:ns_unapplied     Namespace._ua_lock (+ _consumed)
    90     leaf:ns_apply         Namespace._apply_lock
    90     leaf:drain_gate       CleanupThread._drain_lock
    90     leaf:fsync_sched      FsyncEpochScheduler._lock
    90     leaf:fsync_epoch      drain._SyncState.cond
    90     leaf:atomic_int       AtomicInt._lock
    90     leaf:obs              obs.metrics cell-list/registry locks
                                 (cold paths only: first touch per
                                 thread, snapshot on read)
    90     leaf:flight           obs.flight.FlightRecorder._lock — flight
                                 ring slot allocation

Rules (checked by repro.analysis.lockcheck at runtime):

* A thread may only *block* on an ordered lock (level < 90) whose level is
  strictly greater than the highest ordered level it already holds.
* ``multi`` classes may stack same-class acquisitions when the order keys
  are strictly increasing (page locks are taken in ascending page order).
* ``leaf:`` locks (level 90) are terminal by convention — they protect
  short critical sections and never *block* on an ordered lock while
  held.  The checker does not enforce levels for them but still records
  their edges in the global acquisition graph, so a cycle through a leaf
  is reported.
* Non-blocking (try-lock) acquisitions are exempt from level checks —
  they cannot deadlock — but successful ones still count as held
  (``NVCache._reap_file``'s try-lock of ``meta`` and the LRU's try-lock
  eviction rely on this).

Why ``shard`` ranks *after* the page locks (the paper's Alg. 1 narrative
reads log-then-page): the write path (`api.NVCache._pwrite_op`) holds the
touched pages' ``page_atomic`` locks across the whole group commit — the
``on_alloc`` ref registration and the loaded-page patch must be atomic
with the append — so ``LogShard._lock`` is acquired (inside ``alloc`` and
the commit notify) while page locks are held, never the reverse.
Likewise the dirty-miss replay holds ``page_cleanup`` while reading shard
state.  The hierarchy records the code's true order; the commit
*protocol* ordering (entries before head flag before psync) is pmcheck's
job, not this table's.

GUARDED-BY CONTRACT (the second source-of-truth table)
------------------------------------------------------

Alongside the hierarchy, every core class with cross-thread mutable
state declares *which lock guards which field* in a class-level
``GUARDED_BY`` dict, with a ``# guarded-by:`` comment at the field's
definition site.  The declarations are enforced two ways: statically by
``repro.analysis.lint`` (L004 — guarded field accessed outside a
``with <its guard>`` block; L005 — public mutable attribute of a
lock-owning class with no declaration) and at runtime by
``repro.analysis.racecheck`` (RC003 — guarded field touched without the
guard held, plus the RC001/RC002 lockset+vector-clock race analysis).

Spec grammar — ``GUARDED_BY = {"field": spec, ...}`` where spec is:

* ``"attr"``           — the lock at ``self.attr`` must be held for
                         every read and write (once the field is shared
                         between threads);
* ``("a", "b", ...)``  — any-of: condition variables sharing one lock
                         (e.g. a shard's ``_lock``/``_space``/
                         ``_committed``) — holding any satisfies;
* ``"write:attr"``     — writes require the lock; reads are lock-free
                         by design (immutable-swap tables: the router's
                         epoch table, the radix tree) and excluded from
                         the read-write race analysis;
* ``None``             — no lock: ordering comes from happens-before
                         edges only (thread-confined state published at
                         start/join/Event handoffs, e.g. the drain
                         thread's span carry).  racecheck still applies
                         the epoch analysis, but not RC003;
* ``VOLATILE``         — racy by design (approximate counters,
                         opportunistic hints).  Excluded from every
                         check; keep rare and justified in the
                         ``# guarded-by:`` comment.

Subclasses inherit and may extend the parent's table; use
:func:`guards` to read the merged view.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Optional

LEAF_LEVEL = 90

_ROW = re.compile(r"^\s+(\d+)\s+((?:leaf:)?[a-z_]+)(\s+multi)?(?:\s|$)")


def parse_hierarchy(doc: Optional[str] = None) -> Dict[str, dict]:
    """Parse the LOCK HIERARCHY table out of this module's docstring (the
    single source of truth — lint.py calls this too).  Returns
    ``{class_name: {"level": int, "multi": bool}}``."""
    table: Dict[str, dict] = {}
    in_table = False
    for line in (doc or __doc__).splitlines():
        if "LOCK HIERARCHY" in line:
            in_table = True
            continue
        if not in_table:
            continue
        if line.strip().startswith(("level", "-----")):
            continue
        m = _ROW.match(line)
        if m:
            lvl, name, multi = int(m.group(1)), m.group(2), bool(m.group(3))
            table[name] = {"level": lvl, "multi": multi}
        elif line.strip() == "" and table:
            break  # blank line ends the table
    return table


HIERARCHY: Dict[str, dict] = parse_hierarchy()

#: guarded-by spec for fields that are racy by design (see the
#: GUARDED-BY CONTRACT section of the module docstring)
VOLATILE = "volatile"


def guards(cls: type) -> Dict[str, object]:
    """Merged ``GUARDED_BY`` view of ``cls`` across its MRO (subclasses
    inherit the parent's declarations and may extend/override them).
    Returns ``{}`` for classes with no declarations."""
    merged: Dict[str, object] = {}
    for c in reversed(cls.__mro__):
        own = c.__dict__.get("GUARDED_BY")
        if own:
            merged.update(own)
    return merged

# Installed by repro.analysis.sanitize before any stack is constructed;
# when None the factories return raw threading primitives (zero overhead).
_tracer = None


def set_tracer(tracer) -> None:
    global _tracer
    _tracer = tracer


def _check_name(name: str) -> dict:
    info = HIERARCHY.get(name)
    if info is None:
        raise ValueError(f"lock class {name!r} not in the hierarchy table "
                         f"(core/locking.py docstring)")
    return info


def make_lock(name: str, order_key=None, group=None):
    """A ``threading.Lock`` registered under hierarchy class ``name``.

    ``order_key`` orders same-class acquisitions of ``multi`` classes
    (e.g. ``page_no``); ``group`` scopes that comparison (e.g. the owning
    file) so unrelated key spaces are not compared."""
    info = _check_name(name)
    if _tracer is None:
        return threading.Lock()
    return _tracer.traced_lock(name, info, order_key=order_key, group=group)


def make_rlock(name: str):
    """A ``threading.RLock`` registered under hierarchy class ``name``."""
    info = _check_name(name)
    if _tracer is None:
        return threading.RLock()
    return _tracer.traced_lock(name, info, rlock=True)


def make_condition(name: str, lock=None):
    """A ``threading.Condition`` registered under hierarchy class ``name``.

    With ``lock`` given (already a registered lock) the condition shares
    it — acquisitions through the condition are traced via the shared
    lock.  Without one, a fresh registered RLock backs it (``Condition()``
    semantics)."""
    if lock is None:
        lock = make_rlock(name)
    else:
        _check_name(name)
    return threading.Condition(lock)
