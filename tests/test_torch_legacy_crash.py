"""The twin of ``tests/test_legacy_crash.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

Fuse-randomized crash consistency of the legacy workload models:
SQLite rollback-journal + WAL, RocksDB-style WAL+MANIFEST, over NVCache
with K ∈ {1, 2, 4} shards.

Each trial runs the unmodified application protocol over NVCacheFS with a
fuse wired into the NVMM that blows at a uniformly random persistence-
protocol point; the crash then adversarially evicts half the un-flushed
cachelines.  After NVCache recovery, the *application's own* recovery
runs over the recovered tier (TierFS — the app is legacy code, it runs on
anything), and the model's oracle must observe a legal state:

* every transaction acknowledged before the crash is present;
* the in-flight transaction is whole or absent — never torn;
* no resurrected journal/WAL (unlink is the rollback-journal commit
  point; a WAL that outlives its MANIFEST double-applies records);
* the read path stayed full-scan-free (``stats_full_scans == 0``).
"""
import random

import pytest

from repro_torch.core import NVCache, Policy
from repro_torch.storage.fsapi import NVCacheFS, TierFS
from repro_torch.storage.legacy import RocksLite, SQLiteRollbackDB, SQLiteWALDB
from repro_torch.storage.tiers import DRAM, Tier
from _torch_engine import PowerLoss, ThreadFusedNVMM, clone_tier, full_scan_guard  # noqa: F401


def make_policy(k: int) -> Policy:
    return Policy(entry_size=256, log_entries=256 * k, page_size=256,
                  read_cache_pages=16, batch_min=4, batch_max=32,
                  shards=k, shard_route="fdid")


def _run_sqlite_rj(fs, tracker):
    db = SQLiteRollbackDB(fs, page_size=256, npages=6)
    for t in range(1, 8):
        tracker["started"] = t
        db.commit(t)
        tracker["acked"] = t
    db.close()


def _run_sqlite_wal(fs, tracker):
    db = SQLiteWALDB(fs, page_size=256, npages=6)
    for t in range(1, 8):
        tracker["started"] = t
        db.commit(t)
        tracker["acked"] = t
        if t % 3 == 0:
            db.checkpoint()
    db.close()


def _run_rocks(fs, tracker):
    db = RocksLite(fs)
    for i in range(1, 15):
        tracker["started"] = i
        db.put(*RocksLite.kv(i))
        tracker["acked"] = i
        if i % 5 == 0:
            wal = db._wal_path(db.wal_num)
            db.flush()
            tracker["flushed_wals"].append(wal)
    db.close()


def _check_sqlite_rj(fs, tracker):
    db = SQLiteRollbackDB(fs, page_size=256, npages=6)  # app recovery
    t = db.check_consistent(tracker["acked"], tracker["started"])
    db.close()
    return t


def _check_sqlite_wal(fs, tracker):
    db = SQLiteWALDB(fs, page_size=256, npages=6)
    t = db.check_consistent(tracker["acked"], tracker["started"])
    db.close()
    return t


def _check_rocks(fs, tracker):
    db = RocksLite(fs)
    m = db.check_consistent(tracker["acked"], tracker["started"],
                            tracker["flushed_wals"])
    db.close()
    return m


MODELS = {
    "sqlite-rj": (_run_sqlite_rj, _check_sqlite_rj),
    "sqlite-wal": (_run_sqlite_wal, _check_sqlite_wal),
    "rocksdb": (_run_rocks, _check_rocks),
}


def _dry_total(model: str, pol: Policy) -> int:
    run, _ = MODELS[model]
    dry = ThreadFusedNVMM(pol.nvmm_bytes)
    nv = NVCache(pol, Tier(DRAM), nvmm=dry, recover=False)
    dry.ops = 0
    run(NVCacheFS(nv), {"acked": 0, "started": 0, "flushed_wals": []})
    total = dry.ops
    nv.cleanup.power_loss()
    return total


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_fuse_randomized_crash_yields_legal_app_state(k, model):
    from repro_torch.core import recover
    pol = make_policy(k)
    total = _dry_total(model, pol)
    run, check = MODELS[model]
    trials = 12
    for trial in range(trials):
        rng = random.Random(7000 * k + 31 * trial + hash(model) % 1000)
        nvmm = ThreadFusedNVMM(pol.nvmm_bytes, track=True)
        tier = Tier(DRAM)
        nv = NVCache(pol, tier, nvmm=nvmm, recover=False, track_crashes=True)
        tracker = {"acked": 0, "started": 0, "flushed_wals": []}
        nvmm.arm(rng.randrange(0, total + 1))
        completed = False
        try:
            run(NVCacheFS(nv), tracker)
            completed = True
        except PowerLoss:
            pass
        nvmm._fuse = None
        nv._crashed = True
        nv.cleanup.power_loss()
        nvmm.crash(choose_evicted=lambda lines: [
            l for l in lines if rng.random() < 0.5])
        tier2 = clone_tier(tier)
        recover(nvmm, pol, tier2)
        # the app's own recovery + oracle, over the recovered tier
        observed = check(TierFS(tier2), tracker)
        assert tracker["acked"] <= observed <= tracker["started"]
        if completed:
            assert observed == tracker["started"]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_models_survive_clean_crash_and_reopen_over_nvcache(model):
    """No fuse: run to completion, power-cut, recover, reopen the app over
    a FRESH NVCache on the recovered tier (the restart path)."""
    from repro_torch.core import recover
    pol = make_policy(2)
    run, check = MODELS[model]
    nvmm = ThreadFusedNVMM(pol.nvmm_bytes, track=True)
    tier = Tier(DRAM)
    nv = NVCache(pol, tier, nvmm=nvmm, recover=False, track_crashes=True)
    tracker = {"acked": 0, "started": 0, "flushed_wals": []}
    run(NVCacheFS(nv), tracker)
    nv._crashed = True
    nv.cleanup.power_loss()
    nvmm.crash()
    tier2 = clone_tier(tier)
    recover(nvmm, pol, tier2)
    nv2 = NVCache(pol, tier2)
    assert check(NVCacheFS(nv2), tracker) == tracker["started"]
    nv2.shutdown()
