"""Crash-recovery torture demo on the PyTorch port's engine: a kvlite
database over NVCache is killed at a random point under write load; after
the paper's recovery procedure the database replays its (NVCache-boosted)
data log and every acknowledged write is present.

Usage:  PYTHONPATH=src python examples/torch_crash_recovery_demo.py [seed]
"""
import sys

import numpy as np

from repro_torch.core import NVCache, Policy, recover
from repro_torch.storage.fsapi import NVCacheFS, TierFS
from repro_torch.storage.kvlite import KVLite
from repro_torch.storage.tiers import DRAM, Tier

POL = Policy(entry_size=1024, log_entries=512, page_size=1024,
             read_cache_pages=32, batch_min=8, batch_max=64)


def main(seed: int = 0):
    rng = np.random.default_rng(seed)
    tier = Tier(DRAM)
    nv = NVCache(POL, tier, track_crashes=True)
    db = KVLite(NVCacheFS(nv), "/db", sync=True)

    crash_at = int(rng.integers(50, 400))
    acknowledged = {}
    for i in range(crash_at):
        k = f"key{int(rng.integers(0, 64)):03d}".encode()
        v = rng.bytes(int(rng.integers(10, 200)))
        db.put(k, v)
        acknowledged[k] = v                  # put returned => durable

    print(f"power loss after {crash_at} acknowledged puts "
          f"({nv.log.used_entries} entries still in the NVMM log)")
    nvmm = nv.crash(choose_evicted=lambda lines: [
        l for l in lines if rng.random() < 0.5])   # adversarial eviction

    tier2 = Tier(DRAM)
    for path in tier.paths():
        snap = tier.open(path).snapshot()
        if snap:
            tier2.open(path).pwrite(snap, 0)
    stats = recover(nvmm, POL, tier2.open)
    print(f"recovery replayed {stats.entries_replayed} entries")

    db2 = KVLite(TierFS(tier2), "/db", sync=True)
    missing = sum(1 for k, v in acknowledged.items() if db2.get(k) != v)
    print(f"verified {len(acknowledged)} acknowledged keys: {missing} missing")
    assert missing == 0, "DURABILITY VIOLATION"
    print("OK — every acknowledged write survived the crash")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
