"""The twin of ``tests/test_kvlite.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

kvlite (the 'legacy application'): correctness over both stacks and
replay-on-reopen."""
from repro_torch.core import NVCache, Policy
from repro_torch.storage.fsapi import NVCacheFS, TierFS
from repro_torch.storage.kvlite import KVLite
from repro_torch.storage.tiers import DRAM, Tier
from _torch_engine import full_scan_guard  # noqa: F401

POL = Policy(entry_size=4096, log_entries=256, page_size=4096,
             read_cache_pages=16, batch_min=4, batch_max=64, verify_crc=False)


def test_put_get_over_tier():
    db = KVLite(TierFS(Tier(DRAM)), sync=True)
    for i in range(50):
        db.put(f"k{i}".encode(), f"v{i}".encode() * 3)
    assert db.get(b"k7") == b"v7v7v7"
    assert db.get(b"missing") is None
    assert len(db) == 50


def test_put_get_over_nvcache_unmodified():
    """The same application code runs over NVCache — plug-and-play."""
    nv = NVCache(POL, Tier(DRAM))
    db = KVLite(NVCacheFS(nv), sync=True)
    for i in range(50):
        db.put(f"k{i}".encode(), f"v{i}".encode() * 3)
    assert db.get(b"k49") == b"v49v49v49"
    db.put(b"k7", b"updated")
    assert db.get(b"k7") == b"updated"
    nv.shutdown()


def test_replay_on_reopen():
    tier = Tier(DRAM)
    fs = TierFS(tier)
    db = KVLite(fs, "/db", sync=True)
    db.put(b"a", b"1")
    db.put(b"b", b"2")
    db.put(b"a", b"3")
    db2 = KVLite(TierFS(tier), "/db", sync=True)
    assert db2.get(b"a") == b"3"
    assert db2.get(b"b") == b"2"


def test_replay_stops_at_torn_tail_record():
    """A crash mid-append can leave a header whose klen/vlen extend past
    EOF; replay must stop at the last complete record instead of indexing
    garbage (the failure this guards against: the torn key was indexed
    with a value range past EOF, and the next put appended after the torn
    bytes)."""
    import struct
    tier = Tier(DRAM)
    fs = TierFS(tier)
    db = KVLite(fs, "/db", sync=True)
    db.put(b"whole", b"value-1")
    db.put(b"also", b"value-2")
    good_end = db._end
    db.close()
    # simulate the torn append: a header claiming bytes far past EOF, plus
    # a prefix of the key that never finished
    torn = struct.pack("<II", 9, 1 << 20) + b"torn-"
    raw = tier.open("/db")
    raw.pwrite(torn, good_end)
    db2 = KVLite(TierFS(tier), "/db", sync=True)
    assert db2.get(b"whole") == b"value-1"
    assert db2.get(b"also") == b"value-2"
    assert len(db2) == 2, "torn tail record was indexed"
    assert db2._end == good_end, "replay ran past the last complete record"
    # the next put overwrites the torn bytes and is readable after reopen
    db2.put(b"fresh", b"value-3")
    db3 = KVLite(TierFS(tier), "/db", sync=True)
    assert db3.get(b"fresh") == b"value-3"
    assert len(db3) == 3


def test_replay_stops_at_torn_header():
    """EOF in the middle of a header (not just the payload) is also a torn
    tail: replay must treat it as end-of-log."""
    tier = Tier(DRAM)
    db = KVLite(TierFS(tier), "/db", sync=True)
    db.put(b"k", b"v")
    good_end = db._end
    db.close()
    tier.open("/db").pwrite(b"\x05\x00", good_end)   # 2 bytes of a header
    db2 = KVLite(TierFS(tier), "/db", sync=True)
    assert db2.get(b"k") == b"v"
    assert len(db2) == 1 and db2._end == good_end
