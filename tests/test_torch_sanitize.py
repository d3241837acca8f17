"""The port's sanitizers arm the port's engine, not the JAX package's.

``tests/conftest.py``'s ``--sanitize`` arms only ``repro``'s checkers, so
these cases arm ``repro_torch.analysis`` themselves and disarm it after:

* ``racecheck.install_core()`` instruments ``repro_torch`` classes only
  (``CORE_MODULES`` names ``repro_torch.obs.*`` and the f-string head
  ``repro_torch.core.``: the copy's rule b), the same class names as the
  original's ``install_core()``, and no class of ``repro``;
* a seeded kvlite workload over the port's ``NVCacheFS``, crashed with
  adversarial eviction and recovered, records no violation under
  ``sanitize.install()``: every acknowledged key reads back, the
  persistence shadows saw the commits, and ``uninstall()`` puts the port's
  ``NVMM`` and ``TierFile`` methods back, and ``NVLog.__init__`` behind a
  dormant race-detector wrapper, as the original's ``uninstall()`` leaves
  it (the ``armed`` fixture);
* a planted persistence-ordering bug (``tests/test_pmcheck_planted.py``'s
  log group with its fence dropped) is caught by the sanitizer's
  class-level shadow on the port's ``NVMM``.
"""
import numpy as np
import pytest

from repro.analysis import racecheck as jracecheck
from repro_torch.analysis import racecheck, sanitize
from repro_torch.core import NVCache, Policy, recover
from repro_torch.core.log import NVLog
from repro_torch.core.nvmm import NVMM
from repro_torch.storage.fsapi import NVCacheFS, TierFS
from repro_torch.storage.kvlite import KVLite
from repro_torch.storage.tiers import DRAM, Tier, TierFile
from _torch_engine import clone_tier, full_scan_guard  # noqa: F401
from test_torch_pmcheck_planted import plant_group

POL = Policy(entry_size=1024, log_entries=512, page_size=1024,
             read_cache_pages=32, batch_min=8, batch_max=64)
NVMM_METHODS = ("__init__", "store", "pwb", "pfence", "psync", "crash")
TIER_METHODS = ("pwrite", "pwritev", "fsync")


def _dormant(fn):
    """``fn`` under any race-detector ``__init__`` wrappers left on it."""
    while fn.__name__ == "rc_init":
        fn = fn.__kwdefaults__["_orig"]
    return fn


def _methods():
    return ({n: NVMM.__dict__[n] for n in NVMM_METHODS}, _dormant(NVLog.__dict__["__init__"]),
            {n: TierFile.__dict__[n] for n in TIER_METHODS})


@pytest.fixture
def armed():
    """``sanitize.install()`` for one test, begun as the conftest's guard
    begins a test; uninstalled after, whatever happened.  ``NVMM``'s and
    ``TierFile``'s methods are the originals again.  ``NVLog.__init__`` is
    the original behind one dormant ``rc_init`` (the detector off):
    ``uninstall()`` restores the ``NVLog.__init__`` it saw at install,
    which ``racecheck.install_core()`` had wrapped just before, in the
    original package too.  The fixture puts the bare original back, so
    wrappers do not pile up over tests."""
    assert sanitize.state_or_none() is None
    before, init = _methods(), NVLog.__dict__["__init__"]
    st = sanitize.install()
    st.begin_test()
    try:
        yield st
    finally:
        sanitize.uninstall()
        left = NVLog.__dict__["__init__"]
        NVLog.__init__ = init
    assert sanitize.state_or_none() is None and not racecheck._instrumented
    assert racecheck._active is None and left.__name__ == "rc_init"
    assert _methods() == before and _dormant(left) is init


def test_install_core_instruments_the_port_s_classes_only():
    already = set(jracecheck._instrumented)      # armed by --sanitize, if it is
    added = jracecheck.install_core()
    try:
        want = {c.__name__ for c in set(added) | already}
        assert all(c.__module__.startswith("repro.") for c in set(added) | already)
    finally:
        for cls in added:
            if cls not in already:
                jracecheck.deinstrument(cls)
    assert set(jracecheck._instrumented) == already
    try:
        got = racecheck.install_core()
        assert got and all(c.__module__.startswith("repro_torch.") for c in got)
        assert {c.__name__ for c in got} == want
        assert {c.__module__.split(".")[1] for c in got} >= {"core", "obs"}
        assert all(c.__module__.startswith("repro_torch.") for c in racecheck._instrumented)
        assert set(jracecheck._instrumented) == already     # no class of repro
        for cls in got:
            assert cls.__getattribute__.__name__ == "rc_getattribute"
    finally:
        racecheck.uninstall_core()
    assert not racecheck._instrumented
    assert all(cls.__getattribute__.__name__ != "rc_getattribute" for cls in got)


def test_sanitized_crash_and_recovery_is_clean(armed):
    """The crash demo's workload (seed 3) under the armed sanitizer."""
    rng = np.random.default_rng(3)
    tier = Tier(DRAM)
    nv = NVCache(POL, tier, track_crashes=True)
    assert isinstance(nv.nvmm._pm, sanitize.PMCheck)
    db = KVLite(NVCacheFS(nv), "/db", sync=True)
    acknowledged = {}
    for _ in range(int(rng.integers(150, 300))):
        k = f"key{int(rng.integers(0, 64)):03d}".encode()
        v = rng.bytes(int(rng.integers(10, 200)))
        db.put(k, v)
        acknowledged[k] = v
    nvmm = nv.crash(choose_evicted=lambda lines: [l for l in lines if rng.random() < 0.5])
    tier2 = clone_tier(tier)
    recover(nvmm, POL, tier2.open)
    db2 = KVLite(TierFS(tier2), "/db", sync=True)
    assert all(db2.get(k) == v for k, v in acknowledged.items())
    assert armed.pmchecks and sum(pm.stats_commits for pm in armed.pmchecks) > 0
    assert armed.nvlogs and racecheck._instrumented
    assert armed.end_test() == []


def test_sanitizer_catches_a_planted_missing_fence(armed):
    pol = Policy(entry_size=256, log_entries=64, page_size=256, read_cache_pages=4,
                 batch_min=1, batch_max=8)              # the pmcheck suite's mk()
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    NVLog(nvmm, pol)                              # binds the layout, formats the region
    plant_group(nvmm, pol)                        # the control: clean
    assert armed.end_test() == []
    armed.begin_test()
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    NVLog(nvmm, pol)
    plant_group(nvmm, pol, skip_fence=True)
    errors = armed.end_test()
    assert len(errors) == 1 and "PM001" in errors[0]
