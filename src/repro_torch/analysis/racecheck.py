"""Eraser/FastTrack-style hybrid race detector for the engine's shared
state, driven by the ``GUARDED_BY`` contract in :mod:`repro.core.locking`.

The engine runs five kinds of threads against the same structures —
writer threads, per-shard drain threads, the pager writeback thread, the
rebalance thread, and recovery.  :mod:`lockcheck` proves the locks are
*ordered*; this module checks that shared fields are actually *covered*
by the lock that is supposed to guard them.

Epoch model
-----------
Each thread carries a vector clock (VC).  Happens-before edges advance
and join the clocks at every synchronization the engine uses:

* **lock release → acquire** of any ``TracedLock`` (the releaser's VC is
  joined into the lock, the acquirer joins the lock's VC; the releaser's
  own component then ticks).  Conditions share their lock, so
  ``notify``/``wait`` hand-offs — including the seq-commit hand-off
  through ``NVLog._seq_lock`` and the shard ``_space``/``_committed``
  conditions — are covered by the same edge.
* **Thread.start / Thread.join** — the parent's VC is snapshotted onto
  the child at ``start`` (consumed lazily at the child's first event);
  ``join`` merges the dead child's final VC into the joiner.  This is
  what makes single-threaded setup (``format``/``attach``) and
  post-shutdown stats reads race-free without any lock.
* **Event.set → Event.wait** — the generic hand-off channel
  (``drain_event``, ``stop_event``, the pager's ``pressure``).

Each access to a declared field records an *epoch* (thread, clock) plus
the thread's current lockset (the tracer's held stack).  Two accesses
race when **neither happens-before the other and their locksets are
disjoint** — the hybrid rule: a common lock means mutual exclusion, a
clock edge means ordering, and demanding both be absent keeps untracked
synchronization from producing false positives.

Error codes (one report per ``(code, class, field)``):

* ``RC001`` — write-write race: two writes with conflicting epochs and
  disjoint locksets.
* ``RC002`` — read-write race: a read and a write with conflicting
  epochs and disjoint locksets.
* ``RC003`` — a field declared ``GUARDED_BY`` was touched without its
  guard held *while unordered against another thread's accesses*.  The
  happens-before qualifier is what lets init/attach (single-threaded)
  and post-join teardown reads run clean while still catching every
  concurrent guard violation.

Spec handling (grammar in ``repro.core.locking``): ``"attr"`` guards
reads and writes; a tuple is any-of (condition aliases); ``"write:attr"``
checks writes only and removes reads from the analysis (immutable-swap
readers); ``None`` runs the epoch analysis with no RC003;
``locking.VOLATILE`` excludes the field entirely.

Instrumentation
---------------
:func:`instrument` patches a class's ``__getattribute__`` /
``__setattr__`` (works with ``__slots__``) to route declared-field
accesses to the active detector, and wraps ``__init__`` so
under-construction objects are exempt.  Container mutation
(``self.dirty[idx] = t``, ``list.append``) surfaces as an instrumented
*read* of the field — RC003 still checks the guard; the epoch analysis
sees it as a read.  All hooks dispatch through the module-global
:data:`_active` detector, so :func:`arm` can swap a local
:class:`RaceCheck` in for a planted-bug test without touching the
``--sanitize`` session state (the same trick as ``pmcheck.attach``).

Known blind spot: thread idents can be reused after ``join``; a shadow
epoch left by a dead thread is attributed to its successor (a possible
false *negative*, never a false positive).  Per-test shadow resets keep
the window small.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.trace import Reporter, tid, tname
from repro_torch.core import locking

__all__ = ["RaceCheck", "FieldSpec", "arm", "instrument", "install_core",
           "uninstall_core", "install_thread_hooks",
           "uninstall_thread_hooks", "set_active", "active"]

# the detector every instrumented hook routes through (swapped by arm())
_active: Optional["RaceCheck"] = None

# per-thread re-entrancy guard.  Detector code itself synchronizes (and
# ``current_thread()`` can mint a ``_DummyThread`` whose __init__ calls
# ``Event.set``): without this, a hook fired from inside a hook deadlocks
# on ``RaceCheck._mu``.  Inner hook calls become no-ops instead.
_busy = threading.local()


def _enter_hook() -> bool:
    if getattr(_busy, "on", False):
        return False
    _busy.on = True
    return True


def _exit_hook() -> None:
    _busy.on = False


def set_active(rc: Optional["RaceCheck"]) -> None:
    global _active
    _active = rc


def active() -> Optional["RaceCheck"]:
    return _active


# --------------------------------------------------------------------- specs

class FieldSpec:
    """Parsed ``GUARDED_BY`` entry."""

    __slots__ = ("mode", "guards", "display")

    def __init__(self, mode: str, guards: Tuple[str, ...], display: str):
        self.mode = mode          # 'guard' | 'write' | 'hb'
        self.guards = guards
        self.display = display


def parse_spec(raw) -> Optional[FieldSpec]:
    """None result == excluded from instrumentation (VOLATILE)."""
    if raw == locking.VOLATILE:
        return None
    if raw is None:
        return FieldSpec("hb", (), "<happens-before>")
    if isinstance(raw, str):
        if raw.startswith("write:"):
            return FieldSpec("write", (raw[len("write:"):],), raw)
        return FieldSpec("guard", (raw,), raw)
    if isinstance(raw, tuple):
        return FieldSpec("guard", tuple(raw), "|".join(raw))
    raise ValueError(f"bad GUARDED_BY spec {raw!r}")


# -------------------------------------------------------------- field shadow

class _FieldState:
    """Per-(object, field) access history."""

    __slots__ = ("wref", "owner", "shared", "w_tid", "w_clock", "w_locks",
                 "w_thread", "w_locknames", "reads")

    def __init__(self, obj, owner: int):
        try:
            self.wref = weakref.ref(obj)
        except TypeError:
            self.wref = None      # unweakrefable: per-test resets cover it
        self.owner = owner
        self.shared = False
        self.w_tid: Optional[int] = None
        self.w_clock = 0
        self.w_locks: frozenset = frozenset()
        self.w_thread = ""
        self.w_locknames = ""
        # tid -> (clock, lockset, thread name); cleared at each write
        self.reads: Dict[int, Tuple[int, frozenset, str]] = {}

    def stale(self, obj) -> bool:
        return self.wref is not None and self.wref() is not obj


class RaceCheck:
    """Vector clocks + locksets + the guarded-by contract, for one armed
    scope (the global ``--sanitize`` session, or one :func:`arm` block)."""

    def __init__(self, tracer, allow: Optional[Set[str]] = None):
        self.tracer = tracer                    # LockTracer: held locksets
        self.rep = Reporter(allow)
        self.violations = self.rep.violations
        self._mu = threading.Lock()             # analysis infra, not core
        self._vc: Dict[int, Dict[int, int]] = {}
        self._sync_vc: Dict[int, Dict[int, int]] = {}   # id(chan) -> VC
        self._sync_pin: Dict[int, object] = {}          # id stability
        self._fields: Dict[Tuple[int, str], _FieldState] = {}
        self._initing: Dict[int, int] = {}      # id(obj) -> __init__ depth
        self.stats_accesses = 0
        self.stats_edges = 0

    # ----------------------------------------------------------- vc helpers
    def _thread_vc(self, t: int) -> Dict[int, int]:
        """The calling thread's VC, lazily initialized from the birth
        snapshot its parent stashed at ``Thread.start``."""
        vc = self._vc.get(t)
        if vc is None:
            vc = self._vc[t] = {}
        cur = threading.current_thread()
        birth = getattr(cur, "_rc_birth", None)
        if birth is not None:
            for k, v in birth.items():
                if vc.get(k, 0) < v:
                    vc[k] = v
            try:
                cur._rc_birth = None
            except AttributeError:
                pass
        if t not in vc:
            vc[t] = 1
        return vc

    @staticmethod
    def _join(dst: Dict[int, int], src: Dict[int, int]) -> None:
        for k, v in src.items():
            if dst.get(k, 0) < v:
                dst[k] = v

    def _channel_publish(self, chan) -> None:
        """release/set side: VC(chan) |= VC(me); tick me."""
        t = tid()
        with self._mu:
            vc = self._thread_vc(t)
            cvc = self._sync_vc.get(id(chan))
            if cvc is None or self._sync_pin.get(id(chan)) is not chan:
                cvc = self._sync_vc[id(chan)] = {}
                self._sync_pin[id(chan)] = chan
            self._join(cvc, vc)
            vc[t] += 1
            self.stats_edges += 1

    def _channel_observe(self, chan) -> None:
        """acquire/wait side: VC(me) |= VC(chan)."""
        t = tid()
        with self._mu:
            vc = self._thread_vc(t)
            cvc = self._sync_vc.get(id(chan))
            if cvc is not None and self._sync_pin.get(id(chan)) is chan:
                self._join(vc, cvc)
                self.stats_edges += 1

    # --------------------------------------------------- lockcheck forwards
    def on_acquire(self, lock) -> None:
        if not _enter_hook():
            return
        try:
            self._channel_observe(lock)
        finally:
            _exit_hook()

    def on_release(self, lock) -> None:
        if not _enter_hook():
            return
        try:
            self._channel_publish(lock)
        finally:
            _exit_hook()

    # ------------------------------------------------------- thread + event
    def on_thread_start(self, thread) -> None:
        if not _enter_hook():
            return
        try:
            t = tid()
            with self._mu:
                vc = self._thread_vc(t)
                thread._rc_birth = dict(vc)
                vc[t] += 1
                self.stats_edges += 1
        finally:
            _exit_hook()

    def on_thread_join(self, thread) -> None:
        ct = thread.ident
        if ct is None or not _enter_hook():
            return
        try:
            t = tid()
            with self._mu:
                vc = self._thread_vc(t)
                cvc = self._vc.get(ct)
                if cvc is not None and ct != t:
                    self._join(vc, cvc)
                    self.stats_edges += 1
        finally:
            _exit_hook()

    def on_event_set(self, event) -> None:
        if not _enter_hook():
            return
        try:
            self._channel_publish(event)
        finally:
            _exit_hook()

    def on_event_wait(self, event) -> None:
        if not _enter_hook():
            return
        try:
            self._channel_observe(event)
        finally:
            _exit_hook()

    # --------------------------------------------------- construction guard
    def note_init_enter(self, obj) -> None:
        with self._mu:
            self._initing[id(obj)] = self._initing.get(id(obj), 0) + 1

    def note_init_exit(self, obj) -> None:
        with self._mu:
            d = self._initing.get(id(obj), 0) - 1
            if d <= 0:
                self._initing.pop(id(obj), None)
            else:
                self._initing[id(obj)] = d

    # -------------------------------------------------------- field accesses
    def _guard_held(self, obj, spec: FieldSpec) -> bool:
        for gattr in spec.guards:
            try:
                lk = object.__getattribute__(obj, gattr)
            except AttributeError:
                continue
            if isinstance(lk, threading.Condition):
                lk = lk._lock
            owned = getattr(lk, "_is_owned", None)
            if owned is None:
                return True       # untraced primitive: cannot judge — pass
            if owned():
                return True
        return False

    def on_field(self, obj, cls: type, name: str, spec: FieldSpec,
                 is_write: bool) -> None:
        if not is_write and spec.mode == "write":
            return                # lock-free reads by design
        if not _enter_hook():
            return
        try:
            self._on_field(obj, cls, name, spec, is_write)
        finally:
            _exit_hook()

    def _on_field(self, obj, cls: type, name: str, spec: FieldSpec,
                  is_write: bool) -> None:
        t = tid()
        held = self.tracer.held_locks()
        lockset = frozenset(id(l) for l in held)
        with self._mu:
            if self._initing.get(id(obj)):
                return            # under construction: thread-exclusive
            self.stats_accesses += 1
            vc = self._thread_vc(t)
            clock = vc[t]
            key = (id(obj), name)
            st = self._fields.get(key)
            if st is None or st.stale(obj):
                st = self._fields[key] = _FieldState(obj, t)
            if st.owner != t:
                st.shared = True
            me = tname()
            cfield = f"{cls.__name__}.{name}"

            def hb(atid: int, aclock: int) -> bool:
                return vc.get(atid, 0) >= aclock

            # epoch + lockset analysis (the hybrid rule)
            if st.w_tid is not None and st.w_tid != t \
                    and not hb(st.w_tid, st.w_clock) \
                    and not (st.w_locks & lockset):
                code = "RC001" if is_write else "RC002"
                kind = "write-write" if is_write else "read-write"
                self.rep.flag(
                    code,
                    f"{kind} race on {cfield}: {me} "
                    f"({self._locknames(held)}) vs write by {st.w_thread} "
                    f"({st.w_locknames}); no happens-before edge orders "
                    f"them",
                    key=(code, cls.__name__, name))
            if is_write:
                for rt, (rclock, rlocks, rthread) in st.reads.items():
                    if rt != t and not hb(rt, rclock) \
                            and not (rlocks & lockset):
                        self.rep.flag(
                            "RC002",
                            f"read-write race on {cfield}: write by {me} "
                            f"({self._locknames(held)}) vs read by "
                            f"{rthread}; no happens-before edge orders "
                            f"them",
                            key=("RC002", cls.__name__, name))
                        break

            # guarded-by discipline (RC003): only once shared between
            # threads, and only when genuinely unordered against another
            # thread's accesses — single-threaded setup and post-join
            # teardown reads stay clean.
            if st.shared and spec.mode in ("guard", "write") \
                    and (spec.mode == "guard" or is_write):
                others: List[Tuple[int, int]] = []
                if st.w_tid is not None and st.w_tid != t:
                    others.append((st.w_tid, st.w_clock))
                others.extend((rt, r[0]) for rt, r in st.reads.items()
                              if rt != t)
                if any(not hb(at, ac) for at, ac in others) \
                        and not self._guard_held(obj, spec):
                    verb = "written" if is_write else "read"
                    self.rep.flag(
                        "RC003",
                        f"{cfield} {verb} by {me} without its declared "
                        f"guard ({spec.display}) held "
                        f"(held: {self._locknames(held)})",
                        key=("RC003", cls.__name__, name))

            # record this access
            if is_write:
                st.w_tid, st.w_clock = t, clock
                st.w_locks, st.w_thread = lockset, me
                st.w_locknames = self._locknames(held)
                st.reads.clear()
            else:
                st.reads[t] = (clock, lockset, me)

    @staticmethod
    def _locknames(held) -> str:
        return "locks {" + ", ".join(l.name for l in held) + "}"

    # ------------------------------------------------------------- per-test
    def begin_test(self) -> None:
        """Fresh field shadows and dedup keys (clocks/edges persist —
        threads outlive tests)."""
        with self._mu:
            self._fields.clear()
        self.rep.reset_dedup()


# ----------------------------------------------------------- instrumentation

# cls -> (orig __getattribute__, orig __setattr__, orig __init__)
_instrumented: Dict[type, tuple] = {}


def instrument(cls: type) -> bool:
    """Patch ``cls`` so accesses to its declared fields are routed to the
    active detector.  Idempotent; returns True when the class has
    checkable declarations."""
    if cls in _instrumented:
        return True
    specs: Dict[str, FieldSpec] = {}
    for fname, raw in locking.guards(cls).items():
        sp = parse_spec(raw)
        if sp is not None:
            specs[fname] = sp
    if not specs:
        return False
    for base in cls.__mro__[1:]:
        if base in _instrumented:
            # the inherited (instrumented) methods already intercept the
            # ancestor's declared fields — wrapping them again here would
            # double-report every access; only newly-declared names need
            # a subclass wrapper
            inherited = locking.guards(base)
            specs = {f: s for f, s in specs.items() if f not in inherited}
            break
    if not specs:
        return True                    # fully covered by an ancestor's wrap
    names = frozenset(specs)
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__
    orig_init = cls.__init__

    def rc_getattribute(self, name, _names=names, _orig=orig_get,
                        _cls=cls, _specs=specs):
        if name in _names:
            rc = _active
            if rc is not None:
                rc.on_field(self, _cls, name, _specs[name], False)
        return _orig(self, name)

    def rc_setattr(self, name, value, _names=names, _orig=orig_set,
                   _cls=cls, _specs=specs):
        if name in _names:
            rc = _active
            if rc is not None:
                rc.on_field(self, _cls, name, _specs[name], True)
        _orig(self, name, value)

    def rc_init(self, *a, _orig=orig_init, **kw):
        rc = _active
        if rc is None:
            return _orig(self, *a, **kw)
        rc.note_init_enter(self)
        try:
            return _orig(self, *a, **kw)
        finally:
            rc.note_init_exit(self)

    cls.__getattribute__ = rc_getattribute
    cls.__setattr__ = rc_setattr
    cls.__init__ = rc_init
    _instrumented[cls] = (orig_get, orig_set, orig_init)
    return True


def deinstrument(cls: type) -> None:
    orig = _instrumented.pop(cls, None)
    if orig is not None:
        cls.__getattribute__, cls.__setattr__, cls.__init__ = orig


#: core modules whose GUARDED_BY-bearing classes install_core instruments;
#: bare names resolve under ``repro.core``, dotted names are absolute
CORE_MODULES = ("api", "log", "cleanup", "pager", "router", "namespace",
                "readcache", "drain",
                "repro_torch.obs.metrics", "repro_torch.obs.flight")


def install_core() -> List[type]:
    """Instrument every declared class in the core modules (idempotent)."""
    import importlib
    done: List[type] = []
    for modname in CORE_MODULES:
        mod = importlib.import_module(
            modname if "." in modname else f"repro_torch.core.{modname}")
        for obj in list(vars(mod).values()):
            if isinstance(obj, type) and obj.__module__ == mod.__name__ \
                    and locking.guards(obj):
                if instrument(obj):
                    done.append(obj)
    return done


def uninstall_core() -> None:
    for cls in list(_instrumented):
        deinstrument(cls)


# ---------------------------------------------------- thread/event HB hooks

_thread_orig: Dict[str, object] = {}


def install_thread_hooks() -> None:
    """Patch ``Thread.start``/``join`` and ``Event.set``/``wait`` so the
    detector sees the engine's thread-lifecycle and hand-off edges.
    No-ops (one attribute load) while no detector is active."""
    if _thread_orig:
        return
    _thread_orig["start"] = threading.Thread.start
    _thread_orig["join"] = threading.Thread.join
    _thread_orig["set"] = threading.Event.set
    _thread_orig["wait"] = threading.Event.wait

    def start(self):
        rc = _active
        if rc is not None:
            rc.on_thread_start(self)
        return _thread_orig["start"](self)

    def join(self, timeout=None):
        r = _thread_orig["join"](self, timeout)
        rc = _active
        if rc is not None and not self.is_alive():
            rc.on_thread_join(self)
        return r

    def ev_set(self):
        rc = _active
        if rc is not None:
            rc.on_event_set(self)      # publish BEFORE waking waiters
        return _thread_orig["set"](self)

    def ev_wait(self, timeout=None):
        ok = _thread_orig["wait"](self, timeout)
        rc = _active
        if ok and rc is not None:
            rc.on_event_wait(self)
        return ok

    threading.Thread.start = start
    threading.Thread.join = join
    threading.Event.set = ev_set
    threading.Event.wait = ev_wait


def uninstall_thread_hooks() -> None:
    if not _thread_orig:
        return
    threading.Thread.start = _thread_orig["start"]
    threading.Thread.join = _thread_orig["join"]
    threading.Event.set = _thread_orig["set"]
    threading.Event.wait = _thread_orig["wait"]
    _thread_orig.clear()


# ------------------------------------------------------------------ arm()

@contextlib.contextmanager
def arm(tracer=None, allow: Optional[Set[str]] = None):
    """Arm a fresh :class:`RaceCheck` for the duration of the block.

    Works standalone (a temporary ``LockTracer`` is registered with
    ``locking`` so engine locks built inside the block are traced) and
    under ``--sanitize`` (attaches to the session tracer but swaps in a
    *local* detector, so intentional planted races never reach the
    session's violation sink — the ``pmcheck.attach`` trick).
    """
    from repro_torch.analysis.lockcheck import LockTracer

    own_tracer = False
    if tracer is None:
        tracer = locking._tracer
        if tracer is None:
            tracer = LockTracer()
            locking.set_tracer(tracer)
            own_tracer = True
    rc = RaceCheck(tracer, allow=allow)
    install_core()
    install_thread_hooks()
    prev_active = _active
    prev_race = getattr(tracer, "race", None)
    tracer.race = rc
    set_active(rc)
    try:
        yield rc
    finally:
        set_active(prev_active)
        tracer.race = prev_race
        if own_tracer:
            locking.set_tracer(None)
        if prev_active is None:
            from repro_torch.analysis import sanitize
            if sanitize.state_or_none() is None:
                # plain run: leave no instrumentation overhead behind
                uninstall_core()
                uninstall_thread_hooks()
