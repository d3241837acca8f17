"""Benchmark orchestrator — one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV lines.  Scaled to finish in a few
minutes on this 1-core container (see benchmarks/backends.py SCALE for how
device-time calibration keeps the paper's cross-stack ratios meaningful).

  fig3  db_bench-style kvlite workloads x 7 stacks        (paper Fig. 3)
  fig4  ideal-case FIO random write, log never saturates  (paper Fig. 4)
  fig5  log-saturation collapse vs log size               (paper Fig. 5)
  fig6  cleanup batching effect                           (paper Fig. 6)
  fig7  read-cache size insensitivity                     (paper Fig. 7)
  fig8  drain coalescing vs entry-at-a-time + fsync epoch (beyond paper;
        machine-readable via benchmarks/run_all.py -> BENCH_pr2.json)
  ckpt  checkpoint-path booster comparison                (beyond paper)
  kern  kernel micro-bench + oracle parity                (framework)
  roofline  per-(arch x shape) terms from dry-run HLO     (see EXPERIMENTS.md)
"""
from __future__ import annotations

import os
import sys

KERN_REFUSED = (
    "kern is not twinned: benchmarks/kernels_bench.py times the JAX oracle and Pallas "
    "interpret mode; the card's kernel times come from repro_torch.launch.bench_attention, "
    "repro_torch.launch.bench_ssd and chip_smoke.py phase 2")


def main() -> None:
    which = set(sys.argv[1:]) or {"fig3", "fig4", "fig5", "fig6", "fig7",
                                  "fig8", "ckpt"}
    if "kern" in which:
        sys.exit(KERN_REFUSED)
    if "fig3" in which:
        from repro_torch.launch.engine_bench import fig3_dbbench
        fig3_dbbench.run(n_ops=1200)
    if "fig4" in which:
        from repro_torch.launch.engine_bench import fig4_ideal
        fig4_ideal.run(total_mib=8)
    if "fig5" in which:
        from repro_torch.launch.engine_bench import fig5_saturation
        fig5_saturation.run(total_mib=12, log_sizes_mib=(1, 3, 24))
    if "fig6" in which:
        from repro_torch.launch.engine_bench import fig6_batching
        fig6_batching.run(total_mib=6, log_mib=1, batch_sizes=(1, 10, 100, 1000))
    if "fig7" in which:
        from repro_torch.launch.engine_bench import fig7_readcache
        fig7_readcache.run(total_mib=6, cache_pages=(8, 128, 4096))
    if "fig8" in which:
        from repro_torch.launch.engine_bench import fig8_coalescing
        fig8_coalescing.run_coalesce_compare(total_mib=4)
        fig8_coalescing.run_fsync_epoch(total_mib=2)
        fig8_coalescing.run_dirty_miss(n_pages=64)
    if "ckpt" in which:
        from repro_torch.launch import ckpt_bench
        ckpt_bench.run(mib=16)
    if "roofline" in which:
        from repro_torch.launch import roofline
        rows = roofline.table()
        print(roofline.fmt_table(rows))


if __name__ == "__main__":
    main()
