"""The twin of ``tests/test_obs.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

Observability plane: metrics registry, span profiler, flight
recorder.

Covers the four contracts the plane makes:

* histogram math — log2-ns bucket placement, percentile interpolation
  clamped to observed extremes, and zero-count safety (an empty window
  reads 0.0 everywhere, never NaN and never a count-less average);
* concurrency — per-thread cells merge to EXACT totals under an
  8-writer hammer with concurrent readers (runs racecheck-instrumented
  here, and pmcheck/lockcheck-shadowed under ``--sanitize``);
* flight ring — wraparound keeps exactly the last lap ordered by eseq,
  torn tail records are CRC-dropped rather than mis-decoded, and a fuse
  sweep over a crashing workload always recovers a seq-consistent
  forensic timeline;
* level gating — ``obs_level=0`` keeps the pwrite hot path free of any
  allocation inside ``repro_torch.obs`` (the "a few ns per op" promise).
"""
import dataclasses
import os
import threading
import time
import tracemalloc

import pytest

from repro_torch.analysis import racecheck
from repro_torch.core import NVCache, Policy, recover
from repro_torch.core.log import LogFullTimeout, NVLog
from repro_torch.core.nvmm import NVMM
from repro_torch.obs import metrics
from repro_torch.obs.flight import (EV_COMMIT, EV_META_OP, EV_NAMES,
                              EV_ROUTE_EPOCH, FLIGHT_REC, FlightRecorder,
                              decode_ring)
from repro_torch.obs.metrics import Counter, Histogram, Registry, check_name
from repro_torch.storage.tiers import DRAM, Tier
from _torch_engine import PowerLoss, ThreadFusedNVMM, clone_tier, full_scan_guard  # noqa: F401

POL = Policy(entry_size=256, log_entries=128, page_size=256,
             read_cache_pages=8, batch_min=4, batch_max=16)
POL_NODRAIN = dataclasses.replace(POL, batch_min=10 ** 6, batch_max=10 ** 6)


# --------------------------------------------------------- histogram math
def test_histogram_log2_bucket_boundaries():
    """Bucket i holds [2^(i-1), 2^i); bucket 0 holds exactly the value 0."""
    h = Histogram("t.bucket_us")
    for v in (0, 1, 2, 3, 4, 7):
        h.record_ns(v)
    buckets, count, total, vmin, vmax = h._merged()
    assert (count, total, vmin, vmax) == (6, 17, 0, 7)
    assert buckets[0] == 1                   # the value 0
    assert buckets[1] == 1                   # [1, 2)
    assert buckets[2] == 2                   # [2, 4)
    assert buckets[3] == 2                   # [4, 8)
    assert sum(buckets) == 6


def test_percentiles_interpolate_and_clamp_to_extremes():
    h = Histogram("t.lat_us")
    for _ in range(99):
        h.record_ns(1000)
    h.record_ns(1_000_000)
    # p50 interpolates inside 1000's bucket [512, 1024) but can never
    # undercut the observed minimum
    assert 1000 <= h.percentile_ns(0.50) < 1024
    # p999 lands in the outlier's bucket [2^19, 2^20)
    assert 524288 <= h.percentile_ns(0.999) <= 1_000_000
    # q=1.0 clamps to the observed maximum exactly
    assert h.percentile_ns(1.0) == 1_000_000
    # a single-valued distribution is exact at every quantile
    h2 = Histogram("t.flat_us")
    for _ in range(10):
        h2.record_ns(300)
    for q in (0.0, 0.5, 0.95, 0.999, 1.0):
        assert h2.percentile_ns(q) == 300


def test_empty_histogram_reads_zero_not_nan():
    h = Histogram("t.empty_us")
    assert h.count == 0
    assert h.mean_ns() == 0.0
    assert h.percentile_ns(0.5) == 0.0
    snap = h.snapshot()
    assert snap["count"] == 0
    assert snap["mean_us"] == 0.0
    assert snap["p99_us"] == 0.0
    assert snap["sum_us"] == 0.0


def test_snapshot_units_follow_name_suffix():
    h_us = Histogram("t.a_us")
    h_us.record_ns(2000)
    s = h_us.snapshot()
    assert s["sum_us"] == pytest.approx(2.0)
    assert set(s) == {"count", "sum_us", "mean_us", "min_us", "max_us",
                      "p50_us", "p95_us", "p99_us", "p999_us"}
    h_s = Histogram("t.b_s")
    h_s.record_ns(2_000_000_000)
    assert h_s.snapshot()["sum_s"] == pytest.approx(2.0)


def test_merged_snapshot_pools_shard_histograms():
    a, b = Histogram("log.alloc_wait_us"), Histogram("log.alloc_wait_us")
    a.record_ns(1000)
    b.record_ns(3000)
    b.record_ns(500)
    pooled = Histogram.merged_snapshot("log.alloc_wait_us", [a, b])
    assert pooled["count"] == 3
    assert pooled["sum_us"] == pytest.approx(4.5)
    assert pooled["min_us"] == pytest.approx(0.5)
    assert pooled["max_us"] == pytest.approx(3.0)


# ------------------------------------------------------- naming + registry
def test_name_grammar_enforced():
    for bad in ("pwbs", "nvmm.pwbs", "Nvmm.pwb_total", "nvmm.pwb-total",
                "a.b_furlongs", "nvmm..pwb_total", "nvmm.pwb_total_"):
        with pytest.raises(ValueError):
            check_name(bad)
    for good in ("nvmm.pwb_total", "log.alloc_wait_us", "route.skew_ratio",
                 "page.frame_used_count", "nvmm.stored_bytes"):
        assert check_name(good) == good


def test_registry_rejects_duplicates_and_fans_out_groups():
    reg = Registry()
    reg.counter("x.a_total")
    with pytest.raises(ValueError):
        reg.counter("x.a_total")
    reg.bind_group({"y.hit_total": "hits", "y.miss_total": "misses"},
                   lambda: {"hits": 3})
    with pytest.raises(ValueError):
        reg.gauge("y.hit_total")             # group names are reserved too
    snap = reg.snapshot()
    assert snap["y.hit_total"] == 3
    assert snap["y.miss_total"] == 0         # missing dict key reads as 0
    assert "y.hit_total" in reg.names()


# ------------------------------------------------------ shard-merge hammer
def test_shard_merge_exact_under_8_writer_hammer():
    """8 threads hammer one Counter and one Histogram while the main
    thread snapshots concurrently: totals must come out EXACT (per-thread
    cells lose no increment) and racecheck must stay silent on the
    ``_cells`` list discipline."""
    racecheck.instrument(metrics._Sharded)
    racecheck.instrument(metrics.Registry)
    try:
        with racecheck.arm() as rc:
            reg = Registry()
            c = reg.counter("hammer.op_total")
            h = reg.histogram("hammer.op_us")
            n_threads, incs, recs = 8, 20000, 500
            start = threading.Barrier(n_threads)

            def work(tid):
                start.wait()
                for _ in range(incs):
                    c.inc()
                for _ in range(recs):
                    h.record_ns(1000 + tid)

            ts = [threading.Thread(target=work, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            # concurrent readers: merge while the writers are mid-flight
            while any(t.is_alive() for t in ts):
                assert c.value <= n_threads * incs
                assert h.snapshot()["count"] <= n_threads * recs
            for t in ts:
                t.join()
            assert c.value == n_threads * incs
            assert h.count == n_threads * recs
            assert h.sum_ns == sum(recs * (1000 + t)
                                   for t in range(n_threads))
            assert reg.snapshot()["hammer.op_total"] == n_threads * incs
        assert [v.code for v in rc.violations] == [], \
            [str(v) for v in rc.violations]
    finally:
        racecheck.deinstrument(metrics.Registry)
        racecheck.deinstrument(metrics._Sharded)


# ------------------------------------------------------------- flight ring
def test_flight_ring_wraparound_keeps_last_lap():
    pol = dataclasses.replace(POL, flight_records=8)
    nvmm = NVMM(pol.nvmm_bytes)
    fr = FlightRecorder(nvmm, pol)
    for i in range(20):
        fr.record(EV_COMMIT, i, i * 10)
    events, dropped = decode_ring(nvmm, pol)
    assert dropped == 0
    assert [e.eseq for e in events] == list(range(13, 21))
    assert [e.a for e in events] == list(range(12, 20))
    # adopting the ring without a reformat continues the eseq stream
    fr2 = FlightRecorder(nvmm, pol)
    fr2.record(EV_COMMIT, 99)
    events, _ = decode_ring(nvmm, pol)
    assert events[-1].eseq == 21 and events[-1].a == 99


def test_torn_tail_record_is_dropped_not_misdecoded():
    pol = dataclasses.replace(POL, flight_records=8)
    nvmm = NVMM(pol.nvmm_bytes)
    fr = FlightRecorder(nvmm, pol)
    for i in range(5):
        fr.record(EV_COMMIT, i)
    # tear the newest record: flip a payload byte, leave the CRC stale
    off = pol.flight_base + 4 * FLIGHT_REC
    raw = bytearray(bytes(nvmm.load(off, FLIGHT_REC)))
    raw[40] ^= 0xFF
    nvmm.store(off, bytes(raw))
    events, dropped = decode_ring(nvmm, pol)
    assert dropped == 1
    assert [e.eseq for e in events] == [1, 2, 3, 4]
    # never-written slots (5..7) are skipped silently, not counted torn
    assert all(e.type == EV_COMMIT for e in events)


def test_flight_payloads_clamp_none_and_negative_sentinels():
    """Width migrations pass ``new_sid=None`` / negative sentinels as
    payloads; record() must clamp them into u64 instead of raising
    struct.error mid-commit."""
    pol = dataclasses.replace(POL, flight_records=8)
    nvmm = NVMM(pol.nvmm_bytes)
    fr = FlightRecorder(nvmm, pol)
    fr.record(EV_ROUTE_EPOCH, 7, None, -1)
    events, dropped = decode_ring(nvmm, pol)
    assert dropped == 0 and len(events) == 1
    assert events[0].a == 7
    assert events[0].b == 0                  # None -> 0
    assert events[0].c == (1 << 64) - 1      # -1 -> two's-complement u64


@pytest.mark.parametrize("k", [1, 2, 4])
def test_crash_sweep_recovers_seq_consistent_flight_timeline(k):
    """Fuse the NVMM at protocol points across a write+rename+unlink
    workload: whatever survives the crash, recovery's decoded timeline
    must be strictly eseq-increasing with only known event types — and
    once the engine has fenced at least once, non-empty."""
    pol = Policy(entry_size=256, log_entries=128 * k, page_size=256,
                 read_cache_pages=8, batch_min=4, batch_max=16,
                 shards=k, shard_route="fdid", obs_level=1,
                 flight_records=64)

    def script(nv):
        fd = nv.open("/w")
        for i in range(12):
            nv.pwrite(fd, bytes([i + 1]) * 64, i * 64)
        nv.close(fd)
        nv.rename("/w", "/x")
        nv.unlink("/x")

    dry = ThreadFusedNVMM(pol.nvmm_bytes)
    nv = NVCache(pol, Tier(DRAM), nvmm=dry, recover=False)
    dry.ops = 0
    script(nv)
    total = dry.ops
    nv.cleanup.power_loss()

    checked = nonempty = 0
    seen_types = set()
    for fuse in range(1, total + 1, 7):
        nvmm = ThreadFusedNVMM(pol.nvmm_bytes, track=True)
        tier = Tier(DRAM)
        nv = NVCache(pol, tier, nvmm=nvmm, recover=False, track_crashes=True)
        nvmm.arm(fuse)
        try:
            script(nv)
        except PowerLoss:
            pass
        nvmm._fuse = None
        nv._crashed = True
        nv.cleanup.power_loss()
        nvmm.crash()
        stats = recover(nvmm, pol, clone_tier(tier))
        seqs = [e.eseq for e in stats.flight_events]
        assert all(b > a for a, b in zip(seqs, seqs[1:])), \
            f"k={k} fuse={fuse}: non-monotonic flight eseq {seqs}"
        for e in stats.flight_events:
            assert e.type in EV_NAMES, \
                f"k={k} fuse={fuse}: unknown event type {e.type}"
            seen_types.add(e.type)
        checked += 1
        if seqs:
            nonempty += 1
    assert checked > 5
    # flight lines piggyback on engine fences, so only crashes before the
    # FIRST fence may legally lose the whole ring — the bulk of the sweep
    # must come back with forensics
    assert nonempty >= checked // 2, (checked, nonempty)
    assert EV_META_OP in seen_types          # the create/rename/unlink trail
    assert EV_COMMIT in seen_types           # obs_level=1 commit records


# ------------------------------------------------------------ level gating
def test_obs_level0_pwrite_allocates_nothing_in_obs():
    """The off switch must actually be off: with ``obs_level=0`` the
    steady-state pwrite path may not allocate a single object inside
    ``repro_torch.obs`` (no timer boxing, no cell creation, no record packing)."""
    nv = NVCache(POL_NODRAIN, Tier(DRAM))
    fd = nv.open("/quiet")
    nv.pwrite(fd, b"w" * 64, 0)              # warm every lazy path first
    obs_dir = os.path.dirname(metrics.__file__)
    tracemalloc.start()
    try:
        s1 = tracemalloc.take_snapshot()
        for i in range(32):
            nv.pwrite(fd, b"w" * 64, (i + 1) * 64)
        s2 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    growth = [d for d in s2.compare_to(s1, "lineno")
              if d.size_diff > 0
              and d.traceback[0].filename.startswith(obs_dir)]
    assert not growth, [str(d) for d in growth]
    nv.cleanup.power_loss()


def test_profile_report_has_stage_rows_at_level2():
    pol = dataclasses.replace(POL, obs_level=2)
    nv = NVCache(pol, Tier(DRAM))
    fd = nv.open("/p")
    for i in range(20):
        nv.pwrite(fd, b"q" * 64, i * 64)
    nv.flush()
    m = nv.metrics()
    assert m["write.op_us"]["count"] == 20
    # commit spans cover every group append incl. the open()'s meta journal
    assert m["write.commit_us"]["count"] >= 20
    rep = nv.profile_report()
    assert "write.op_us" in rep and "drain." in rep
    nv.shutdown()


def test_profile_report_states_level_zero():
    nv = NVCache(POL, Tier(DRAM))
    fd = nv.open("/z")
    nv.pwrite(fd, b"z" * 64, 0)
    nv.flush()
    assert "no samples" in nv.profile_report()
    nv.shutdown()


# ----------------------------------------------------- alloc-wait contract
def test_alloc_wait_zero_count_reads_zero_not_nan():
    """The failing-before edge: a window with zero waits used to report a
    bare seconds sum that readers divided by an assumed count — now the
    count rides along and every derived stat reads 0, not NaN."""
    nv = NVCache(POL, Tier(DRAM))
    s = nv.stats()
    assert s["alloc_waits"] == 0
    assert s["alloc_wait_s"] == 0.0
    assert s["alloc_wait_mean_us"] == 0.0
    assert s["alloc_wait_p95_us"] == 0.0
    samp = nv.log.shards[0].load_sample()
    assert samp["alloc_waits"] == 0
    assert samp["alloc_wait_mean_us"] == 0.0
    nv.shutdown()


def test_alloc_wait_episode_carries_count_and_mean():
    pol = Policy(entry_size=256, log_entries=4, page_size=256,
                 read_cache_pages=4)
    nvmm = NVMM(pol.nvmm_bytes)
    log = NVLog(nvmm, pol, format=True)
    sh = log.shards[0]
    sh.alloc(3)
    sh.alloc(1)                              # shard now full

    def free_soon():
        time.sleep(0.02)
        with sh._space:                      # emulate a drain recycling slots
            sh.volatile_tail = 2
            sh._space.notify_all()

    t = threading.Thread(target=free_soon)
    t.start()
    sh.alloc(2, timeout=5.0)                 # one real log-full episode
    t.join()
    assert sh.alloc_wait.count == 1
    snap = sh.alloc_wait.snapshot()
    assert snap["count"] == 1
    assert snap["sum_us"] > 0
    assert snap["mean_us"] == pytest.approx(snap["sum_us"])
    assert sh.load_sample()["alloc_waits"] == 1
    assert sh.stats_alloc_wait_s == pytest.approx(snap["sum_us"] * 1e-6)


def test_zero_timeout_full_shard_records_no_phantom_wait():
    pol = Policy(entry_size=256, log_entries=4, page_size=256,
                 read_cache_pages=4)
    nvmm = NVMM(pol.nvmm_bytes)
    log = NVLog(nvmm, pol, format=True)
    sh = log.shards[0]
    sh.alloc(3)
    sh.alloc(1)
    with pytest.raises(LogFullTimeout):
        sh.alloc(1, timeout=0.0)
    assert sh.alloc_wait.count == 0          # never waited -> no episode


# --------------------------------------------------------- stats coherence
def test_stats_keeps_legacy_keys_and_matches_registry():
    nv = NVCache(POL, Tier(DRAM))
    fd = nv.open("/s")
    nv.pwrite(fd, b"z" * 300, 0)
    nv.flush()
    s = nv.stats()
    for key in ("shards", "log_used", "lru_hits", "cleanup_batches",
                "nvmm_psyncs", "nvmm_pwbs", "nvmm_fences", "alloc_wait_s",
                "route_epoch", "meta_ops", "mode_migrations",
                "paged_frames_used"):
        assert key in s, key
    m = nv.metrics()
    assert s["nvmm_psyncs"] == m["nvmm.psync_total"]
    assert s["cleanup_batches"] == m["drain.batch_total"]
    assert s["alloc_waits"] == m["log.alloc_wait_us"]["count"]
    assert m["flight.event_total"] > 0       # at least the attach record
    nv.shutdown()
