"""Fig. 4 — ideal case: the log never saturates (log 2x the written data).
Claims checked: NVCache+SSD beats every other synchronous-durability stack,
including the NVMM-native FS (no syscall on the write path)."""
from __future__ import annotations

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.launch.engine_bench.fio_like import random_write

STACKS = ["nvcache+ssd", "nova", "ext4-dax", "dm-writecache", "ssd"]


def run(total_mib: float = 24, stacks=STACKS):
    rows = []
    for name in stacks:
        st = make_stack(name, log_mib=2 * total_mib)
        try:
            r = random_write(st.fs, total_mib=total_mib, file_mib=total_mib)
        finally:
            st.close()
        rows.append({"stack": name, **{k: r[k] for k in
                                       ("seconds", "mib_per_s", "avg_lat_us")}})
        print(f"fig4/{name},{r['avg_lat_us']:.1f},{r['mib_per_s']:.1f}MiB/s",
              flush=True)
    return rows


if __name__ == "__main__":
    run()
