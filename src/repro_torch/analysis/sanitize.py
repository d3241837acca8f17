"""Wire the runtime checkers into a live process (``pytest --sanitize``).

:func:`install` does three things, all before any engine object exists:

* registers a :class:`repro.analysis.lockcheck.LockTracer` with
  :mod:`repro.core.locking`, so every lock subsequently built by the
  ``make_*`` factories is a hierarchy-checked ``TracedLock``;
* patches the :class:`repro.core.nvmm.NVMM` *class* so each instance gets
  a :class:`repro.analysis.pmcheck.PMCheck` shadow at construction and
  every ``store``/``pwb``/``pfence``/``psync``/``crash`` is traced — at
  the base class, so the crash-fuse subclasses the sweeps use (they
  override these methods and call ``super()``) are covered too;
* patches :class:`repro.core.log.NVLog` to bind each adopted region's
  :class:`~repro.core.policy.Policy` into its shadow (commit-point
  detection needs the layout), and the backend
  :class:`repro.storage.tiers.TierFile` I/O entry points to feed
  ``lockcheck``'s I/O-under-shard-lock rule;
* arms :mod:`repro.analysis.racecheck`: the ``GUARDED_BY``-declared
  classes in ``repro.core`` are instrumented, thread/Event lifecycle
  hooks installed, and a session-wide :class:`~repro.analysis.racecheck.
  RaceCheck` attached to the lock tracer (lock edges feed its vector
  clocks; its RC001–RC003 reports fail the test like any other).

The pytest fixture in ``tests/conftest.py`` calls :func:`begin_test` /
:func:`end_test` around every test and fails the test on any accumulated
violation (raising inside a drain thread would hang the pool instead).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis import racecheck
from repro_torch.analysis.lockcheck import LockTracer
from repro_torch.analysis.pmcheck import PMCheck
from repro_torch.analysis.racecheck import RaceCheck
from repro_torch.core.policy import CACHELINE

_state: Optional["SanitizeState"] = None


class SanitizeState:
    def __init__(self):
        self.tracer = LockTracer()
        self.race = RaceCheck(self.tracer)
        self.tracer.race = self.race
        self.pmchecks: List[PMCheck] = []   # created since begin_test()
        self.nvlogs: list = []              # NVLogs created since begin_test()
        self._lc_mark = 0
        self._rc_mark = 0
        self._orig = {}

    # ------------------------------------------------------------ per-test
    def begin_test(self) -> None:
        self.pmchecks.clear()
        self.nvlogs.clear()
        self._lc_mark = self.tracer._rep.mark()
        self.race.begin_test()
        self._rc_mark = self.race.rep.mark()

    def end_test(self, allow_full_scan: bool = False) -> List[str]:
        errors: List[str] = []
        for pm in self.pmchecks:
            errors.extend(repr(v) for v in pm.violations)
        # the class-level graph is cumulative across tests on purpose: two
        # tests driving opposite orders through the same code is a latent
        # deadlock even if no single run interleaves into it (LC003 dedups,
        # so an old cycle is reported once, at the test that closed it)
        self.tracer.check_cycles()
        errors.extend(str(v) for v in self.tracer._rep.since(self._lc_mark))
        errors.extend(str(v) for v in self.race.rep.since(self._rc_mark))
        if not allow_full_scan:
            for log in self.nvlogs:
                if log.stats_full_scans:
                    errors.append(
                        f"FS001: NVLog performed {log.stats_full_scans} full "
                        f"log scan(s) (scan_all_committed is recovery/"
                        f"diagnostic-only; mark the test full_scan_ok if "
                        f"intentional)")
        self.pmchecks.clear()
        self.nvlogs.clear()
        return errors


def state_or_none() -> Optional[SanitizeState]:
    return _state


def install() -> SanitizeState:
    """Idempotent; returns the active state."""
    global _state
    if _state is not None:
        return _state
    st = SanitizeState()

    from repro_torch.core import locking
    locking.set_tracer(st.tracer)

    # ------------------------------------------------------ race detector
    racecheck.install_core()
    racecheck.install_thread_hooks()
    racecheck.set_active(st.race)

    # ---------------------------------------------------- NVMM class hooks
    from repro_torch.core.nvmm import NVMM
    orig = st._orig
    orig["init"] = NVMM.__init__
    orig["store"] = NVMM.store
    orig["pwb"] = NVMM.pwb
    orig["pfence"] = NVMM.pfence
    orig["psync"] = NVMM.psync
    orig["crash"] = NVMM.crash

    def init(self, size, *, track=False):
        orig["init"](self, size, track=track)
        self._pm = PMCheck(self)
        st.pmchecks.append(self._pm)

    def store(self, off, data):
        self._pm.on_store(off, data)
        return orig["store"](self, off, data)

    def pwb(self, off, n=CACHELINE):
        self._pm.on_pwb(off, n)
        return orig["pwb"](self, off, n)

    def pfence(self):
        self._pm.on_fence("pfence")
        return orig["pfence"](self)

    def psync(self):
        self._pm.on_fence("psync")
        return orig["psync"](self)

    def crash(self, choose_evicted=None):
        self._pm.on_crash()
        return orig["crash"](self, choose_evicted)

    NVMM.__init__ = init
    NVMM.store = store
    NVMM.pwb = pwb
    NVMM.pfence = pfence
    NVMM.psync = psync
    NVMM.crash = crash

    # ------------------------------------------- layout binding via NVLog
    from repro_torch.core.log import NVLog
    orig["nvlog_init"] = NVLog.__init__

    def nvlog_init(self, nvmm, policy, **kw):
        pm = getattr(nvmm, "_pm", None)
        if pm is not None:
            pm.bind(policy)               # before format() stores anything
        orig["nvlog_init"](self, nvmm, policy, **kw)
        st.nvlogs.append(self)

    NVLog.__init__ = nvlog_init

    # --------------------------------------------------- backend I/O hooks
    from repro_torch.storage.tiers import TierFile
    for name in ("pwrite", "pwritev", "fsync"):
        orig["tier_" + name] = getattr(TierFile, name)

        def make(name, fn):
            def wrapper(self, *a, **kw):
                st.tracer.on_backend_io(name, getattr(self, "path", ""))
                return fn(self, *a, **kw)
            return wrapper

        setattr(TierFile, name, make(name, orig["tier_" + name]))

    _state = st
    return st


def uninstall() -> None:
    global _state
    if _state is None:
        return
    from repro_torch.core import locking
    from repro_torch.core.nvmm import NVMM
    from repro_torch.core.log import NVLog
    from repro_torch.storage.tiers import TierFile
    o = _state._orig
    locking.set_tracer(None)
    racecheck.set_active(None)
    racecheck.uninstall_core()
    racecheck.uninstall_thread_hooks()
    NVMM.__init__, NVMM.store, NVMM.pwb = o["init"], o["store"], o["pwb"]
    NVMM.pfence, NVMM.psync, NVMM.crash = o["pfence"], o["psync"], o["crash"]
    NVLog.__init__ = o["nvlog_init"]
    for name in ("pwrite", "pwritev", "fsync"):
        setattr(TierFile, name, o["tier_" + name])
    _state = None
