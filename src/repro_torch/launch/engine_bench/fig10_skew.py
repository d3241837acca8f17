"""Fig. 10 — skewed fdid distributions vs the adaptive shard router.

PR 1's static ``fdid % K`` route partitions *unrelated* files cleanly —
until the workload is skewed: fdid assignment is arbitrary (open order), so
several hot files can collide on one shard and the whole multi-writer
workload collapses back to a single shard's commit lock + drain thread (the
per-core-log contention problem of "NVMM cache design: Logging vs.
Paging").  This experiment constructs exactly that adversarial-but-
realistic case: ``FILES`` files whose per-op popularity is Zipf(s), with
the Zipf *ranks* laid out so the hottest K files all collide on shard 0
under ``fdid % K`` (rank r -> file (r % (FILES/K)) * K + r // (FILES/K)).

``run_skew`` measures committed-write throughput of ``threads`` concurrent
writers in the saturated regime (log much smaller than the data), static
``fdid`` route vs ``shard_rebalance=True``: the epoch router samples
per-key load, migrates the colliding hot fdids to lighter shards (each
migration behind the per-file drain barrier) and the workload spreads back
across all K drain threads.  Headline: rebalanced / static committed MiB/s
(acceptance: >= 1.5x at K = 4, 4 writers).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.launch.engine_bench.backends import make_stack


def zipf_file_map(files: int, k: int) -> list:
    """Rank -> file index such that ranks 0..K-1 (the hot files) all map to
    files that are ≡ 0 (mod K): a worst-case-but-legal fdid layout."""
    per = files // k
    return [(r % per) * k + r // per for r in range(files)]


def zipf_probs(files: int, s: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, files + 1), s)
    return p / p.sum()


def concurrent_zipf_write(fs, *, threads: int, total_mib: float,
                          files: int, k: int, zipf_s: float = 1.0,
                          file_mib: float = 4.0, bs: int = 4096,
                          seed: int = 11):
    """N writers; each op picks its file by Zipf rank (shared popularity,
    per-thread RNG) and writes a random ``bs``-aligned offset in it."""
    n_ops = int(total_mib * (1 << 20)) // bs
    per_thread = max(1, n_ops // threads)
    n_slots = max(1, int(file_mib * (1 << 20)) // bs)
    rank_to_file = zipf_file_map(files, k)
    probs = zipf_probs(files, zipf_s)
    buf = b"x" * bs
    fds = [fs.open(f"/skew{i}.dat") for i in range(files)]  # fdid == i
    done = [0] * threads
    lat = [0.0] * threads

    def worker(t):
        rng = np.random.default_rng(seed + t)
        ranks = rng.choice(files, size=per_thread, p=probs)
        offs = rng.integers(0, n_slots, size=per_thread)
        for i in range(per_thread):
            fd = fds[rank_to_file[int(ranks[i])]]
            t0 = time.perf_counter()
            fs.pwrite(fd, buf, int(offs[i]) * bs)
            fs.fsync(fd)
            lat[t] += time.perf_counter() - t0
            done[t] = i + 1

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t_start = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    total = time.perf_counter() - t_start
    ops = sum(done)
    return {
        "seconds": total,
        "mib_per_s": ops * bs / total / (1 << 20),
        "avg_lat_us": 1e6 * sum(lat) / max(1, ops),
        "writes": ops,
        "threads": threads,
        "files": files,
        "zipf_s": zipf_s,
    }


def run_skew(total_mib: float = 10, log_mib: float = 2, threads: int = 4,
             files: int = 16, k: int = 4, zipf_s: float = 1.0,
             warmup_mib: float = 3.0, rebalance_epoch_ms: float = 25.0):
    """Static fdid route vs adaptive rebalancing on the colliding-hot-fdid
    Zipf workload; identical policy otherwise.  ``warmup_mib`` is an
    untimed ramp (fio ``ramp_time`` style) so the figure reports
    *steady-state* throughput — for the static route the ramp changes
    nothing; for the rebalancer it covers the few epochs of convergence
    (migrations keep running in the timed phase; steady state just means
    the table has stopped moving hot keys every epoch)."""
    rows = []
    for mode in ("static-fdid", "rebalance"):
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=50,
                        batch_max=500, shards=k, shard_route="fdid",
                        rebalance=(mode == "rebalance"),
                        rebalance_epoch_ms=rebalance_epoch_ms)
        try:
            if warmup_mib > 0:
                concurrent_zipf_write(st.fs, threads=threads,
                                      total_mib=warmup_mib, files=files,
                                      k=k, zipf_s=zipf_s, seed=7)
            r = concurrent_zipf_write(st.fs, threads=threads,
                                      total_mib=total_mib, files=files,
                                      k=k, zipf_s=zipf_s)
        finally:
            stats = st.nv.stats()
            st.close()
        r.update({"mode": mode, "shards": k,
                  "route_epoch": stats["route_epoch"],
                  "route_migrations": stats["route_migrations"],
                  "route_overrides": stats["route_overrides"],
                  "alloc_wait_s": stats["alloc_wait_s"]})
        rows.append(r)
        print(f"fig10/{mode}@K{k}x{threads}w,{r['avg_lat_us']:.1f},"
              f"{r['mib_per_s']:.1f} MiB/s "
              f"(epoch={r['route_epoch']} migs={r['route_migrations']})",
              flush=True)
    return rows


def run_uniform_guard(total_mib: float = 8, log_mib: float = 2,
                      threads: int = 4, k: int = 4):
    """Uniform (non-skewed) multi-writer load, rebalance on vs off: the
    rebalancer must not tax the balanced case (hysteresis keeps it idle)."""
    from repro_torch.launch.engine_bench.fio_like import concurrent_random_write
    rows = []
    for mode in ("static-fdid", "rebalance"):
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=50,
                        batch_max=500, shards=k, shard_route="fdid",
                        rebalance=(mode == "rebalance"))
        try:
            r = concurrent_random_write(st.fs, threads=threads,
                                        total_mib=total_mib,
                                        file_mib=total_mib)
        finally:
            stats = st.nv.stats()
            st.close()
        rows.append({"mode": mode, "shards": k,
                     "mib_per_s": r["mib_per_s"],
                     "route_migrations": stats["route_migrations"]})
        print(f"fig10/uniform-{mode}@K{k},{r['mib_per_s']:.1f} MiB/s",
              flush=True)
    return rows


if __name__ == "__main__":
    run_skew()
    run_uniform_guard()
