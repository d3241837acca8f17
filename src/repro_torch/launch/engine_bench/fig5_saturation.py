"""Fig. 5 — log saturation: with a log smaller than the written data the
throughput starts at NVMM speed and collapses to the slow tier's drain
rate; smaller logs collapse earlier, all collapse to the same floor.

``run_shard_scaling`` is the beyond-paper experiment: once saturated, the
drain rate is the throughput, and K log shards drain through K independent
cleanup threads — committed-write throughput under multi-writer load should
scale with K until the device is the wall."""
from __future__ import annotations

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import concurrent_random_write, random_write


def run(total_mib: float = 24, log_sizes_mib=(2, 6, 48)):
    rows = []
    for log_mib in log_sizes_mib:
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=200,
                        batch_max=2000)
        try:
            r = random_write(st.fs, total_mib=total_mib, file_mib=total_mib)
        finally:
            st.close()
        if len(r["samples"]) >= 2:
            half = len(r["samples"]) // 2
            early = sum(s["inst_mib_s"] for s in r["samples"][:half]) / half
            late = sum(s["inst_mib_s"] for s in r["samples"][half:]) / \
                (len(r["samples"]) - half)
        else:       # finished inside one interval: never saturated
            early = late = r["mib_per_s"]
        rows.append({"log_mib": log_mib, "mib_per_s": r["mib_per_s"],
                     "early_mib_s": early, "late_mib_s": late,
                     "seconds": r["seconds"]})
        print(f"fig5/log{log_mib}MiB,{r['avg_lat_us']:.1f},"
              f"early={early:.1f} late={late:.1f} MiB/s", flush=True)
    return rows


def run_shard_scaling(total_mib: float = 16, log_mib: float = 2,
                      threads: int = 4, shard_counts=(1, 2, 4)):
    """Committed-write throughput, ``threads`` concurrent writers, one file
    per writer, log much smaller than the data (saturated regime), K shards
    drained by K threads.  Routing is by fdid: unrelated files partition
    cleanly across shards (one drain + fsync stream per file); "stripe"
    routing trades some of that isolation for spreading a single hot file."""
    rows = []
    base = None
    for k in shard_counts:
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=50,
                        batch_max=500, shards=k, shard_route="fdid")
        try:
            r = concurrent_random_write(st.fs, threads=threads,
                                        total_mib=total_mib,
                                        file_mib=total_mib)
        finally:
            st.close()
        if base is None:
            base = r["mib_per_s"]
        speedup = r["mib_per_s"] / base
        rows.append({"shards": k, "threads": threads,
                     "mib_per_s": r["mib_per_s"], "speedup": speedup,
                     "avg_lat_us": r["avg_lat_us"], "seconds": r["seconds"]})
        print(f"fig5/shards{k}x{threads}w,{r['avg_lat_us']:.1f},"
              f"{r['mib_per_s']:.1f} MiB/s ({speedup:.2f}x vs K=1)", flush=True)
    return rows


if __name__ == "__main__":
    run()
    run_shard_scaling()
