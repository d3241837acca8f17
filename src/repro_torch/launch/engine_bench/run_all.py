"""CI entry point: run the PR's headline benchmarks and emit ONE
machine-readable JSON (``BENCH_pr10.json``) so the perf trajectory of the
repo is diffable from PR 2 onward.

    PYTHONPATH=src python benchmarks/run_all.py [--out BENCH_pr10.json] [--quick]

Emitted metrics (schema ``bench_schema: 10``):

* ``latency`` — the PR-10 observability plane: per-stage write-path
  latency percentiles from the span profiler at ``obs_level=2``
  (p50/p95/p99 per stage, foreground spans reconciled against
  wall-clock, a fence-cost row dividing commit-span time through the
  NVMM pwb/fence counters) plus the plain-vs-instrumented overhead
  rows CI gates on; fio-style results across all figures now carry a
  ``lat`` percentile snapshot, not just a running average;
* ``meta`` — reproducibility stamp: git sha, schema, device scale,
  policy knobs and the RNG seeds every figure draws from;
* ``dualmode`` — the PR-7 adaptive logging-vs-paging engine: steady-state
  persisted bytes (NVMM + backend) per committed byte on an
  overwrite-heavy stream, paged vs log mode (acceptance >= 1.5x fewer),
  plus the trickle-parity guard (classifier keeps small-write streams on
  the log; within 5% of the PR-5 tip);

* ``legacy`` — the §IV journal-mode legacy workloads over the durable
  namespace (PR 5): SQLite rollback-journal (per-txn journal fsync +
  hot-journal unlink commit point), SQLite WAL (append + checkpoint/
  ftruncate reset) and RocksDB-style sync puts (WAL fsync per put,
  MANIFEST rename-install per flush), each nvcache+ssd vs the sync-SSD
  baseline;
* ``skew`` — the PR-4 Zipf-skewed rebalancing figure (acceptance >= 1.5x
  vs the static ``fdid`` route) plus the uniform guard;
* ``cold_read`` / ``mixed`` / ``trickle`` / ``coalesce`` /
  ``fsync_epoch_hot_file`` / ``dirty_miss`` — the PR-2/PR-3 figures
  re-measured at this tip (all with ``shard_rebalance=False``, the static
  paper baseline) so regressions stay visible.  ``cold_read`` now runs
  with the PR-5 adaptive readahead ramp (2->4->8).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.launch.engine_bench import (backends, fig3_dbbench, fig8_coalescing,  # noqa: E402
                        fig9_readpath, fig10_skew, fig_dualmode, fig_obs)


def _meta(quick: bool) -> dict:
    """Reproducibility stamp: enough to re-run THIS emission bit-for-bit
    (modulo wall-clock noise) from a clean checkout."""
    import dataclasses
    import subprocess
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 4)
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True,
                             timeout=10).stdout.strip() or None
    except Exception:
        sha = None
    return {
        "git_sha": sha,
        "bench_schema": 10,
        "quick": quick,
        "device_scale": backends.SCALE,
        "policy_defaults": dataclasses.asdict(backends.policy(64)),
        "seeds": {"fio": 11, "skew_workload": 11, "skew_zipf": 7,
                  "dbbench_keys": 7},
    }


def run(quick: bool = False) -> dict:
    total_mib = 4 if quick else 8
    legacy = fig3_dbbench.run_journal(n_txn=60 if quick else 200)
    skew = fig10_skew.run_skew(total_mib=3 if quick else 10,
                               warmup_mib=1.5 if quick else 3.0)
    uniform = fig10_skew.run_uniform_guard(total_mib=3 if quick else 8)
    cold = fig9_readpath.run_cold_read(total_mib=2 if quick else 8)
    mixed = fig9_readpath.run_mixed(total_mib=2 if quick else 6)
    trickle = fig9_readpath.run_trickle(n_writes=64 if quick else 192)
    rows = fig8_coalescing.run_coalesce_compare(total_mib=total_mib)
    epoch = fig8_coalescing.run_fsync_epoch(total_mib=2 if quick else 4)
    dm = fig8_coalescing.run_dirty_miss(n_pages=64 if quick else 192)
    dual = fig_dualmode.run_bytes_per_committed(
        n_pages=16 if quick else 32, passes=4 if quick else 8)
    dual_trickle = fig_dualmode.run_trickle_parity(
        n_writes=64 if quick else 192)
    spans = fig_obs.run_span_breakdown(total_mib=1.5 if quick else 3.0)
    overhead = fig_obs.run_obs_overhead(total_mib=1.0 if quick else 2.0,
                                        repeats=3 if quick else 5)

    leg_by = {(r["model"], r["stack"]): r for r in legacy}

    def _legacy_block(model):
        nv = leg_by[(model, "nvcache+ssd")]
        ssd = leg_by[(model, "ssd")]
        return {
            "txn_per_s": nv["txn_per_s"],
            "txn_per_s_ssd": ssd["txn_per_s"],
            "speedup_x_vs_ssd": nv["txn_per_s"] / max(1e-12,
                                                      ssd["txn_per_s"]),
            "meta_ops": nv.get("meta_ops"),
            "log_full_scans": nv.get("log_full_scans"),
        }

    skew_by = {r["mode"]: r for r in skew}
    uni_by = {r["mode"]: r for r in uniform}
    cold_by_ra = {r["readahead_pages"]: r for r in cold}
    mixed_by_ra = {r["readahead_pages"]: r for r in mixed}
    trickle_by = {r["mode"]: r for r in trickle}
    by_mode = {r["mode"]: r for r in rows}
    entry, coal = by_mode["entry-at-a-time"], by_mode["coalesced"]
    ropb1 = cold_by_ra[1]["read_ops_per_byte"]
    ropb8 = cold_by_ra[8]["read_ops_per_byte"]
    ppb_tip = trickle_by["pr2-tip"]["backend_page_writes_per_committed_byte"]
    ppb_span = trickle_by["span-batches"]["backend_page_writes_per_committed_byte"]
    dual_by = {r["mode"]: r for r in dual}
    dual_tr_by = {r["mode"]: r for r in dual_trickle}
    bpc_log = dual_by["log"]["persisted_per_committed_byte"]
    bpc_paged = dual_by["paged"]["persisted_per_committed_byte"]
    clat = spans["clat"]
    return {
        "bench_schema": 10,
        "pr": 10,
        "meta": _meta(quick),
        "latency": {
            "clat_p50_us": clat["p50_us"],
            "clat_p95_us": clat["p95_us"],
            "clat_p99_us": clat["p99_us"],
            "op_p50_us": spans["op_p50_us"],
            "op_p95_us": spans["op_p95_us"],
            "op_p99_us": spans["op_p99_us"],
            "span_coverage_ratio": spans["span_coverage_ratio"],
            "stages": spans["stages"],
            "fence_cost": spans["fence_cost"],
            "obs_overhead_pct": overhead["overhead_pct"],
            "detail": [spans, overhead],
        },
        "dualmode": {
            "persisted_bytes_per_committed_byte_paged": bpc_paged,
            "persisted_bytes_per_committed_byte_log": bpc_log,
            "byte_reduction_x": bpc_log / max(1e-12, bpc_paged),
            "mode_migrations": dual_by["paged"]["mode_migrations"],
            "log_full_scans": dual_by["paged"]["log_full_scans"],
            "trickle_us_per_write": dual_tr_by["dual-engine"]["us_per_write"],
            "trickle_us_per_write_pr5_tip": dual_tr_by["pr5-tip"]["us_per_write"],
            "trickle_overhead_pct": 100.0
                * (dual_tr_by["dual-engine"]["us_per_write"]
                   - dual_tr_by["pr5-tip"]["us_per_write"])
                / max(1e-12, dual_tr_by["pr5-tip"]["us_per_write"]),
            "detail": dual + dual_trickle,
        },
        "legacy": {
            "sqlite_rollback_journal": _legacy_block("sqlite-rj"),
            "sqlite_wal": _legacy_block("sqlite-wal"),
            "rocksdb_style": _legacy_block("rocksdb"),
            "detail": legacy,
        },
        "skew": {
            "mib_per_s": skew_by["rebalance"]["mib_per_s"],
            "mib_per_s_static_fdid": skew_by["static-fdid"]["mib_per_s"],
            "rebalance_speedup_x": skew_by["rebalance"]["mib_per_s"]
                / max(1e-12, skew_by["static-fdid"]["mib_per_s"]),
            "route_epoch": skew_by["rebalance"]["route_epoch"],
            "route_migrations": skew_by["rebalance"]["route_migrations"],
            "uniform_mib_per_s": uni_by["rebalance"]["mib_per_s"],
            "uniform_mib_per_s_static_fdid": uni_by["static-fdid"]["mib_per_s"],
            "uniform_migrations": uni_by["rebalance"]["route_migrations"],
            "detail": skew + uniform,
        },
        "cold_read": {
            "mib_per_s": cold_by_ra[8]["mib_per_s"],
            "mib_per_s_readahead1": cold_by_ra[1]["mib_per_s"],
            "read_ops_per_byte": ropb8,
            "read_ops_per_byte_readahead1": ropb1,
            "read_op_reduction_x": ropb1 / max(1e-12, ropb8),
            "readahead_hit_rate": cold_by_ra[8]["readahead_hit_rate"],
            "detail": cold,
        },
        "mixed": {
            "mib_per_s": mixed_by_ra[8]["mib_per_s"],
            "mib_per_s_readahead1": mixed_by_ra[1]["mib_per_s"],
            "log_full_scans": mixed_by_ra[8]["log_full_scans"],
            "detail": mixed,
        },
        "trickle": {
            "page_writes_per_committed_byte": ppb_span,
            "page_writes_per_committed_byte_pr2_tip": ppb_tip,
            "page_write_reduction_x": ppb_tip / max(1e-12, ppb_span),
            "detail": trickle,
        },
        "coalesce": {
            "committed_mib_s": coal["mib_per_s"],
            "committed_mib_s_entry_at_a_time": entry["mib_per_s"],
            "page_writes_per_committed_byte":
                coal["backend_page_writes_per_committed_byte"],
            "page_writes_per_committed_byte_entry_at_a_time":
                entry["backend_page_writes_per_committed_byte"],
            "page_write_reduction_x":
                entry["backend_page_writes_per_committed_byte"]
                / max(1e-12, coal["backend_page_writes_per_committed_byte"]),
            "detail": rows,
        },
        "fsync_epoch_hot_file": epoch,
        "dirty_miss": dm,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join("build", "engine_bench.json"))
    ap.add_argument("--quick", action="store_true",
                    help="smaller workload for CI smoke runs")
    args = ap.parse_args()
    result = run(quick=args.quick)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=2, sort_keys=True)
        fh.write("\n")
    leg = result["legacy"]
    lat = result["latency"]
    print(f"latency plane: commit p50/p95/p99 "
          f"{lat['clat_p50_us']:.0f}/{lat['clat_p95_us']:.0f}/"
          f"{lat['clat_p99_us']:.0f}us, span coverage "
          f"{100 * lat['span_coverage_ratio']:.1f}% of wall-clock, "
          f"obs_level=2 overhead {lat['obs_overhead_pct']:+.1f}%",
          flush=True)
    print(f"wrote {args.out}: dual persistence engine — paged mode persists "
          f"{result['dualmode']['byte_reduction_x']:.2f}x fewer bytes per "
          f"committed byte than the log on overwrite-heavy streams "
          f"(trickle overhead "
          f"{result['dualmode']['trickle_overhead_pct']:+.1f}%); "
          f"legacy workloads over the durable namespace — "
          f"SQLite rollback-journal "
          f"{leg['sqlite_rollback_journal']['speedup_x_vs_ssd']:.1f}x, "
          f"SQLite WAL {leg['sqlite_wal']['speedup_x_vs_ssd']:.1f}x, "
          f"RocksDB-style {leg['rocksdb_style']['speedup_x_vs_ssd']:.1f}x "
          f"vs sync SSD; "
          f"{result['skew']['rebalance_speedup_x']:.2f}x skewed-fdid "
          f"rebalance, "
          f"{result['cold_read']['read_op_reduction_x']:.1f}x fewer backend "
          f"read ops/byte (ramped ra=8 vs 1), "
          f"{result['coalesce']['committed_mib_s']:.1f} MiB/s committed",
          flush=True)


if __name__ == "__main__":
    main()
