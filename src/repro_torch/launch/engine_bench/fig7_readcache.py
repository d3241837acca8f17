"""Fig. 7 — read-cache size insensitivity: mixed 50/50 random read/write;
the read cache exists for *consistency* (dirty reads), not performance, so
throughput is flat across 100 entries ... 1M entries (scaled)."""
from __future__ import annotations

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import random_write


def run(total_mib: float = 12, cache_pages=(8, 128, 4096)):
    rows = []
    for pages in cache_pages:
        # readahead pinned to 1: this figure reproduces the paper's
        # per-page Fig. 2 miss procedure (the PR-3 extent read path has
        # its own figure, benchmarks/fig9_readpath.py)
        st = make_stack("nvcache+ssd", log_mib=4 * total_mib,
                        read_pages=pages, readahead=1)
        try:
            r = random_write(st.fs, total_mib=total_mib, file_mib=total_mib,
                             read_fraction=0.5)
            stats = st.nv.stats()
        finally:
            st.close()
        rows.append({"pages": pages, "mib_per_s": r["mib_per_s"],
                     "lru_hits": stats["lru_hits"], "lru_misses": stats["lru_misses"],
                     "dirty_misses": stats["dirty_misses"],
                     "seconds": r["seconds"]})
        hr = stats["lru_hits"] / max(1, stats["lru_hits"] + stats["lru_misses"])
        print(f"fig7/cache{pages}p,{r['avg_lat_us']:.1f},"
              f"{r['mib_per_s']:.1f}MiB/s hit={hr:.0%}", flush=True)
    return rows


if __name__ == "__main__":
    run()
