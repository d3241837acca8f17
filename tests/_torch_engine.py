"""Helpers of the engine test twins (``tests/test_torch_{kvlite,legacy_crash,
lockcheck,pmcheck_planted,racecheck_planted,obs,sanitize}.py``), built on
the port's engine classes.

* ``PowerLoss``, ``FusedNVMM`` (``tests/test_sharded_recovery.py``),
  ``ThreadFusedNVMM`` and ``clone_tier`` (``tests/test_namespace.py``):
  the same code over ``repro_torch``'s ``NVMM`` and ``Tier``;
* ``full_scan_guard``: ``tests/conftest.py``'s always-on full-scan guard,
  which registers only ``repro``'s ``NVLog``, for the port's ``NVLog``.
  A twin file imports it, and it fails any of that file's tests across
  which the port's logs' ``stats_full_scans`` grew (``full_scan_ok``
  exempts a test, as there).
"""
import threading
import weakref

import pytest

from repro_torch.core import NVMM
from repro_torch.core.log import NVLog
from repro_torch.core.policy import CACHELINE
from repro_torch.storage.tiers import DRAM, Tier


class PowerLoss(Exception):
    pass


class FusedNVMM(NVMM):
    """NVMM that dies after a set number of persistence-protocol ops."""

    def __init__(self, size, *, track=False):
        super().__init__(size, track=track)
        self.ops = 0
        self._fuse = None

    def arm(self, n) -> None:
        self._fuse = n

    def _tick(self):
        self.ops += 1
        if self._fuse is not None:
            if self._fuse <= 0:
                raise PowerLoss()
            self._fuse -= 1

    def store(self, off, data):
        self._tick()
        super().store(off, data)

    def pwb(self, off, n=CACHELINE):
        self._tick()
        super().pwb(off, n)

    def pfence(self):
        self._tick()
        super().pfence()

    def psync(self):
        self._tick()
        super().psync()


class ThreadFusedNVMM(FusedNVMM):
    """Fuse that ticks (and blows) only on the constructing thread: the
    app-visible crash point is deterministic, while the drain threads —
    whose progress at that instant is inherently racy — keep running until
    the crash itself, exactly like real power loss."""

    def __init__(self, size, *, track=False):
        super().__init__(size, track=track)
        self._owner = threading.get_ident()

    def _tick(self):
        if threading.get_ident() != self._owner:
            return
        super()._tick()


def clone_tier(tier, *, drop=(), ns_seq=None):
    """The backend state an instant after the crash.  ``drop`` + ``ns_seq``
    simulate a kernel that lost a *suffix* of namespace updates (files
    created/renamed after the last directory sync): the dropped files
    disappear and the applied watermark rolls back with them — recovery
    must then rebuild exactly that suffix from the NVMM log."""
    t2 = Tier(DRAM)
    for p in tier.paths():
        if p in drop:
            continue
        snap = tier.open(p).snapshot()
        f2 = t2.open(p)
        if snap:
            f2.pwrite(snap, 0)
    t2.ns_seq = tier.ns_seq if ns_seq is None else ns_seq
    return t2


_nvlog_refs = []
if not getattr(NVLog.__init__, "_full_scan_guard", False):
    _orig_init = NVLog.__init__

    def _init(self, *a, **kw):
        _orig_init(self, *a, **kw)
        _nvlog_refs.append(weakref.ref(self))

    _init._full_scan_guard = True
    NVLog.__init__ = _init


def _total_full_scans() -> int:
    alive = [r() for r in _nvlog_refs]
    if len(alive) > 64 and None in alive:       # prune dead refs
        _nvlog_refs[:] = [r for r in _nvlog_refs if r() is not None]
    return sum(log.stats_full_scans for log in alive if log is not None)


@pytest.fixture(autouse=True)
def full_scan_guard(request):
    """Fail a test that made the port's logs scan the whole log."""
    base = _total_full_scans()
    yield
    if "full_scan_ok" not in request.keywords:
        delta = _total_full_scans() - base
        if delta > 0:
            pytest.fail(f"FS001: {delta} full log scan(s) during this test "
                        f"(scan_all_committed is recovery/diagnostic-only; mark "
                        f"the test full_scan_ok if intentional)", pytrace=False)
