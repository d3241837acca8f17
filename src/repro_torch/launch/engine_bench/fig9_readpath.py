"""Fig. 9 (beyond paper) — the extent-granular read path and batch-spanning
drain coalescing (PR 3), vs the PR-2 tip and the paper baseline.

Three experiments:

* ``run_cold_read`` — cold sequential scan of a file that lives only on the
  slow tier (page cache dropped): with ``readahead_pages=R`` a cache miss
  loads one aligned R-page extent through ``TierFile.preadv`` instead of R
  single-page ``pread`` calls.  Figure of merit: *backend page-read
  operations (syscalls) per byte read* — the read-side twin of PR 2's
  page-writes-per-committed-byte.  ``readahead_pages=1`` is the paper's
  Fig. 2 per-page miss procedure.
* ``run_mixed`` — 50/50 random read/write (fio-style, fsync=1 semantics):
  end-to-end throughput with and without readahead, dirty misses included —
  readahead must never bypass the dirty-page-index replay, so this also
  guards the consistency cost.
* ``run_trickle`` — a slow writer issuing small contiguous writes so every
  drain batch is tiny (``batch_min`` low): the PR-2 tip
  (``coalesce_span_batches=False``) degenerates to ~one backend page write
  per batch because each batch re-writes the still-filling tail page; the
  batch-spanning carry defers the open tail page until it is full (or the
  ``coalesce_deadline_ms`` expires), restoring ~one write per page.
"""
from __future__ import annotations

import time

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import random_write

PS = 4096


def _prefill_cold(stack, path: str, nbytes: int) -> None:
    """Put ``nbytes`` on the slow tier only, then drop the page cache so
    the next reads are cold (device-cost) reads."""
    f = stack.tier.open(path)
    f.pwrite(b"\xC5" * nbytes, 0)
    f.fsync()
    f.drop_page_cache()


def run_cold_read(total_mib: float = 8, readaheads=(1, 8), bs: int = PS):
    """Cold sequential read at each readahead setting."""
    nbytes = int(total_mib * (1 << 20))
    rows = []
    for ra in readaheads:
        st = make_stack("nvcache+ssd", log_mib=2, readahead=ra)
        try:
            _prefill_cold(st, "/cold.dat", nbytes)
            fd = st.fs.open("/cold.dat")
            t0 = time.perf_counter()
            for off in range(0, nbytes, bs):
                st.fs.pread(fd, bs, off)
            dt = time.perf_counter() - t0
            tf = st.tier.open("/cold.dat")
            s = st.nv.stats()
            row = {
                "readahead_pages": ra,
                "bs": bs,
                "bytes": nbytes,
                "seconds": dt,
                "mib_per_s": nbytes / dt / (1 << 20),
                "backend_preads": tf.stats_preads,
                "backend_page_reads": tf.stats_page_reads,
                "read_ops_per_byte": tf.stats_preads / nbytes,
                "readahead_loads": s["readahead_loads"],
                "readahead_hit_rate": s["readahead_hit_rate"],
                "log_full_scans": s["log_full_scans"],
            }
        finally:
            st.close()
        rows.append(row)
        print(f"fig9/cold_read_ra{ra},{1e6 * dt * bs / nbytes:.1f},"
              f"{row['mib_per_s']:.1f} MiB/s "
              f"ops/MiB={row['backend_preads'] / max(1e-9, nbytes / (1 << 20)):.0f}",
              flush=True)
    return rows


def run_mixed(total_mib: float = 6, readaheads=(1, 8)):
    """Mixed 50/50 random read/write through the full stack."""
    rows = []
    for ra in readaheads:
        st = make_stack("nvcache+ssd", log_mib=4 * total_mib, readahead=ra)
        try:
            r = random_write(st.fs, total_mib=total_mib, file_mib=total_mib,
                             read_fraction=0.5)
            s = st.nv.stats()
            tf = st.tier.open("/fio.dat")
            row = {
                "readahead_pages": ra,
                "mib_per_s": r["mib_per_s"],
                "avg_lat_us": r["avg_lat_us"],
                "reads": r["reads"], "writes": r["writes"],
                "backend_preads": tf.stats_preads,
                "dirty_misses": s["dirty_misses"],
                "readahead_hit_rate": s["readahead_hit_rate"],
                "log_full_scans": s["log_full_scans"],
            }
        finally:
            st.close()
        rows.append(row)
        print(f"fig9/mixed_ra{ra},{row['avg_lat_us']:.1f},"
              f"{row['mib_per_s']:.1f} MiB/s", flush=True)
    return rows


def run_trickle(n_writes: int = 192, bs: int = 1024, gap_s: float = 0.002,
                deadline_ms: float = 100.0):
    """Small-batch trickle: one writer, contiguous ``bs``-byte writes with a
    think-time gap, ``batch_min=1`` so the drain runs per tiny batch."""
    rows = []
    for span in (False, True):
        st = make_stack("nvcache+ssd", log_mib=2, batch_min=1, batch_max=500,
                        span_batches=span, deadline_ms=deadline_ms)
        try:
            fd = st.fs.open("/trickle.dat")
            buf = b"t" * bs
            t0 = time.perf_counter()
            for i in range(n_writes):
                st.fs.pwrite(fd, buf, i * bs)
                if gap_s:
                    time.sleep(gap_s)
            st.nv.flush()
            dt = time.perf_counter() - t0
            tf = st.tier.open("/trickle.dat")
            s = st.nv.stats()
            committed = n_writes * bs
            row = {
                "mode": "span-batches" if span else "pr2-tip",
                "writes": n_writes, "bs": bs,
                "committed_bytes": committed,
                "seconds": dt,
                "backend_pwrites": tf.stats_writes,
                "backend_page_writes": tf.stats_page_writes,
                "backend_page_writes_per_committed_byte":
                    tf.stats_page_writes / committed,
                "drain_deferred": s["drain_deferred"],
                "drain_span_merges": s["drain_span_merges"],
                "cleanup_batches": s["cleanup_batches"],
            }
        finally:
            st.close()
        rows.append(row)
        print(f"fig9/trickle_{row['mode']},{1e6 * dt / n_writes:.1f},"
              f"pagewrites/MiB="
              f"{row['backend_page_writes'] / max(1e-9, committed / (1 << 20)):.0f}",
              flush=True)
    return rows


if __name__ == "__main__":
    run_cold_read()
    run_mixed()
    run_trickle()
