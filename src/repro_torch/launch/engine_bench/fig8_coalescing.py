"""Fig. 8 (beyond paper) — the page-coalescing drain engine vs the paper's
entry-at-a-time forwarding, on the workload it targets: several writers
issuing small (1 KiB) *sequential* synchronous writes into a saturated log,
so the drain rate IS the committed-write throughput (cf. Fig. 5).

``run_coalesce_compare`` runs the identical workload twice — once with
``drain_coalesce=False, fsync_epoch=False`` (one backend pwrite + one
dirty-counter dance per log entry) and once with the plan/apply engine —
and reports, per mode, committed MiB/s and *backend page writes per
committed byte* (from the tier's ``stats_page_writes``), the
dm-writeboost-style figure of merit: one submitted write for hundreds of
data blocks.

``run_dirty_miss`` measures the read half of the refactor: dirty-miss
latency with the per-page entry index (O(entries-on-page) replay) and the
entries-inspected-per-miss ratio, with the drain held off so every miss is
maximally dirty.
"""
from __future__ import annotations

import time

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import concurrent_seq_write


def _tier_write_stats(tier) -> dict:
    files = [tier.open(p) for p in tier.paths()]
    return {
        "pwrites": sum(f.stats_writes for f in files),
        "page_writes": sum(f.stats_page_writes for f in files),
        "wvec_segments": sum(f.stats_wvec_segments for f in files),
        "bytes": sum(f.stats_bytes for f in files),
    }


def run_coalesce_compare(total_mib: float = 8, log_mib: float = 2,
                         threads: int = 4, bs: int = 1024, shards: int = 4):
    """The PR-2 headline experiment: 4 writers x 1 KiB sequential, log much
    smaller than the data (saturated), K=4 shards routed by fdid."""
    rows = []
    for coalesce in (False, True):
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=50,
                        batch_max=500, shards=shards, shard_route="fdid",
                        drain_coalesce=coalesce, fsync_epoch=coalesce)
        try:
            r = concurrent_seq_write(st.fs, threads=threads,
                                     total_mib=total_mib, bs=bs)
            st.nv.flush()                      # count every drained byte
            tstats = _tier_write_stats(st.tier)
            nvstats = st.nv.stats()
        finally:
            st.close()
        committed = r["bytes"]
        row = {
            "mode": "coalesced" if coalesce else "entry-at-a-time",
            "threads": threads, "bs": bs, "shards": shards,
            "mib_per_s": r["mib_per_s"],
            "avg_lat_us": r["avg_lat_us"],
            "seconds": r["seconds"],
            "committed_bytes": committed,
            "backend_pwrites": tstats["pwrites"],
            "backend_page_writes": tstats["page_writes"],
            "backend_page_writes_per_committed_byte":
                tstats["page_writes"] / max(1, committed),
            "backend_pwrites_per_committed_byte":
                tstats["pwrites"] / max(1, committed),
            "fsyncs_requested": nvstats["cleanup_fsyncs"],
            "fsyncs_issued": nvstats["cleanup_fsyncs_issued"],
            "drain_extents": nvstats["drain_extents"],
            "drain_pwritevs": nvstats["drain_pwritevs"],
        }
        rows.append(row)
        print(f"fig8/{row['mode']},{r['avg_lat_us']:.1f},"
              f"{r['mib_per_s']:.1f} MiB/s "
              f"pagewrites/MiB={row['backend_page_writes'] / max(1e-9, committed / (1 << 20)):.0f}",
              flush=True)
    return rows


def run_fsync_epoch(total_mib: float = 4, log_mib: float = 2,
                    threads: int = 4, bs: int = 1024, shards: int = 4):
    """Cross-shard fsync merging: one HOT file under stripe routing spreads
    across every shard, so K drain threads keep fsyncing the same backend
    file — the epoch scheduler collapses the concurrent ones."""
    st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=50,
                    batch_max=500, shards=shards, shard_route="stripe")
    try:
        r = concurrent_seq_write(st.fs, threads=threads, total_mib=total_mib,
                                 bs=bs, path_tmpl="/hot.dat")
        st.nv.flush()
        s = st.nv.stats()
    finally:
        st.close()
    out = {"threads": threads, "shards": shards,
           "mib_per_s": r["mib_per_s"],
           "fsyncs_requested": s["cleanup_fsyncs"],
           "fsyncs_issued": s["cleanup_fsyncs_issued"],
           "fsyncs_merged": s["cleanup_fsyncs_merged"]}
    print(f"fig8/fsync_epoch,{r['avg_lat_us']:.1f},"
          f"{out['fsyncs_requested']} fsync requests -> "
          f"{out['fsyncs_issued']} issued "
          f"({out['fsyncs_merged']} merged)", flush=True)
    return out


def run_dirty_miss(n_pages: int = 192, writes_per_page: int = 4,
                   bs: int = 1024):
    """Dirty-miss read latency with the per-page index.

    The log is large and ``batch_min`` high, so nothing drains: every page
    has ``writes_per_page`` live entries and a tiny read cache forces every
    pread through the miss path."""
    st = make_stack("nvcache+ssd", log_mib=16, batch_min=10000,
                    batch_max=10000, read_pages=2)
    try:
        fd = st.fs.open("/dm.dat")
        ps = st.nv.policy.page_size
        assert bs * writes_per_page <= ps
        for p in range(n_pages):
            for j in range(writes_per_page):
                st.fs.pwrite(fd, b"d" * bs, p * ps + j * bs)
        t0 = time.perf_counter()
        for p in range(n_pages):
            st.fs.pread(fd, ps, p * ps)
        dt = time.perf_counter() - t0
        s = st.nv.stats()
        out = {
            "pages": n_pages,
            "writes_per_page": writes_per_page,
            "dirty_misses": s["dirty_misses"],
            "replay_entries": s["replay_entries"],
            "entries_inspected_per_miss":
                s["replay_entries"] / max(1, s["dirty_misses"]),
            "log_full_scans": s["log_full_scans"],
            "avg_miss_lat_us": 1e6 * dt / n_pages,
        }
        print(f"fig8/dirty_miss,{out['avg_miss_lat_us']:.1f},"
              f"{out['entries_inspected_per_miss']:.1f} entries/miss "
              f"(full log scans: {out['log_full_scans']})", flush=True)
        return out
    finally:
        st.close()


if __name__ == "__main__":
    run_coalesce_compare()
    run_dirty_miss()
