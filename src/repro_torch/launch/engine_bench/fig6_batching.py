"""Fig. 6 — batching effect: in the saturated regime throughput tracks the
cleanup thread's fsync amortization; batch=1 is worse than the raw slow
tier (syscall per entry), large batches converge (write-combining)."""
from __future__ import annotations

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import random_write


def run(total_mib: float = 12, log_mib: float = 2,
        batch_sizes=(1, 10, 100, 1000)):
    rows = []
    for b in batch_sizes:
        st = make_stack("nvcache+ssd", log_mib=log_mib, batch_min=b,
                        batch_max=max(b, b * 10))
        try:
            r = random_write(st.fs, total_mib=total_mib, file_mib=total_mib)
            stats = st.nv.stats()
        finally:
            st.close()
        rows.append({"batch": b, "mib_per_s": r["mib_per_s"],
                     "fsyncs": stats["cleanup_fsyncs"],
                     "entries": stats["cleanup_entries"],
                     "seconds": r["seconds"]})
        print(f"fig6/batch{b},{r['avg_lat_us']:.1f},{r['mib_per_s']:.1f}MiB/s"
              f" fsyncs={stats['cleanup_fsyncs']}", flush=True)
    return rows


if __name__ == "__main__":
    run()
