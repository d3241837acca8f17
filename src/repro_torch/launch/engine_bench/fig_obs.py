"""Observability-plane figures (PR 10).

Two measurements over the nvcache+ssd stack:

* ``run_span_breakdown`` — fsync=1 random writes at ``obs_level=2``; the
  span profiler's per-stage histograms become the latency breakdown
  (p50/p95/p99 per stage), reconciled two ways: the foreground spans
  (op + drain-barrier stall) must add up to the workload wall-clock, and
  the commit-span totals are divided through the NVMM ``pwb``/fence
  counters into a fence-cost row (µs of commit time per fence, pwbs per
  committed group).
* ``run_obs_overhead`` — the same workload plain vs fully instrumented;
  CI fails the build when ``obs_level=2`` costs more than 10% on
  µs-per-op (and ``obs_level=0`` must be free — that guard is the
  tracemalloc test in ``tests/test_obs.py``).
"""
from __future__ import annotations

import os
import sys
import time

from repro_torch.launch.engine_bench import backends, fio_like  # noqa: E402


def _stage_rows(m: dict) -> list:
    """Every span histogram in a metrics snapshot, as breakdown rows."""
    rows = []
    for name in sorted(m):
        v = m[name]
        if not (isinstance(v, dict) and name.endswith("_us") and v.get("count")):
            continue
        rows.append({"stage": name, "count": v["count"],
                     "sum_us": v["sum_us"], "p50_us": v["p50_us"],
                     "p95_us": v["p95_us"], "p99_us": v["p99_us"]})
    return rows


def run_span_breakdown(total_mib: float = 3.0, file_mib: float = 2.0,
                       bs: int = 4096, log_mib: float = 2.0) -> dict:
    """Single-writer fsync=1 random writes with the profiler at level 2."""
    st = backends.make_stack("nvcache+ssd", log_mib=log_mib, obs_level=2)
    try:
        t0 = time.perf_counter()
        res = fio_like.random_write(st.fs, total_mib=total_mib,
                                    file_mib=file_mib, bs=bs)
        wall_s = time.perf_counter() - t0
        m = st.nv.metrics()
        s = st.nv.stats()
    finally:
        st.close()
    op = m["write.op_us"]
    barrier = m["stall.barrier_us"]
    commit = m["write.commit_us"]
    # one writer: the op spans plus the fsync drain-barrier stalls ARE the
    # foreground time; whatever wall-clock they fail to cover is harness
    # overhead (rng, timestamping) and must stay inside 10%
    fg_span_s = (op["sum_us"] + barrier["sum_us"]) * 1e-6
    fences = max(1, s["nvmm_fences"])
    return {
        "mode": "span-breakdown",
        "obs_level": 2,
        "wall_s": wall_s,
        "mib_per_s": res["mib_per_s"],
        "clat": res["lat"],
        "op_p50_us": op["p50_us"], "op_p95_us": op["p95_us"],
        "op_p99_us": op["p99_us"],
        "foreground_span_s": fg_span_s,
        "span_coverage_ratio": fg_span_s / max(1e-12, wall_s),
        "stages": _stage_rows(m),
        "fence_cost": {
            "nvmm_pwbs": s["nvmm_pwbs"],
            "nvmm_pwb_lines": s["nvmm_pwb_lines"],
            "nvmm_fences": s["nvmm_fences"],
            "nvmm_psyncs": s["nvmm_psyncs"],
            "commit_spans": commit["count"],
            "commit_span_sum_us": commit["sum_us"],
            "pwbs_per_commit": s["nvmm_pwbs"] / max(1, commit["count"]),
            "fences_per_commit": s["nvmm_fences"] / max(1, commit["count"]),
            "us_per_fence": commit["sum_us"] / fences,
        },
    }


def _gate_us_per_op(obs_level: int, *, log_mib: float,
                    total_mib: float = 1.0, file_mib: float = 1.0) -> float:
    st = backends.make_stack("nvcache+ssd", log_mib=log_mib,
                             obs_level=obs_level)
    try:
        res = fio_like.random_write(st.fs, total_mib=total_mib,
                                    file_mib=file_mib, bs=4096)
    finally:
        st.close()
    return res["avg_lat_us"]


def _stress_seconds(obs_level: int, *, threads: int, total_mib: float,
                    log_mib: float) -> float:
    st = backends.make_stack("nvcache+ssd", log_mib=log_mib, shards=2,
                             obs_level=obs_level)
    try:
        res = fio_like.concurrent_random_write(st.fs, threads=threads,
                                               total_mib=total_mib,
                                               file_mib=2.0)
    finally:
        st.close()
    return res["seconds"]


def _hot_cpu_us_per_op(obs_level: int, n: int = 4096, bs: int = 4096) -> float:
    """Pure log-commit path (no fsync, drain quiescent, free device):
    CPU µs per pwrite — the worst case for instrumentation, since nothing
    dilutes the span/flight cost."""
    st = backends.make_stack("nvcache+ssd", log_mib=32, scale=0.0,
                             batch_min=10 ** 6, batch_max=10 ** 6,
                             obs_level=obs_level)
    buf = b"x" * bs
    try:
        fd = st.fs.open("/hot.dat")
        for i in range(64):
            st.fs.pwrite(fd, buf, i * bs)
        t0 = time.process_time()
        for i in range(n):
            st.fs.pwrite(fd, buf, (i % 256) * bs)
        dt = time.process_time() - t0
    finally:
        st.nv.cleanup.power_loss()
    return 1e6 * dt / n


def run_obs_overhead(threads: int = 4, total_mib: float = 2.0,
                     log_mib: float = 2.0, repeats: int = 5) -> dict:
    """Plain vs obs_level=2 overhead — the CI gate (<10%) is
    ``overhead_pct``: fsync=1 single-writer µs-per-op, where each op's
    cost is dominated by the deterministic modeled device time (the
    deployment-realistic denominator).  Plain/instrumented runs are
    interleaved back-to-back and the gate takes the MEDIAN of the
    per-pair overheads — back-to-back pairs share the machine's noise
    phase (CPU frequency, co-tenant load), and the median discards the
    pairs a hiccup landed on, so a single slow run can't fail the
    build.  All raw samples are emitted for forensics.  Two context
    rows ride along un-gated: the N-thread stress wall seconds (same
    workload family, but batching dynamics dominate its run-to-run
    noise) and the pure hot-path CPU µs/op — the undiluted worst case,
    i.e. what spans plus sampled flight records cost when nothing else
    is on the op (expect tens of percent there; that is exactly why
    level 2 is opt-in and level 0 is the default)."""
    pairs = []
    gate_plain, gate_full = [], []
    for _ in range(repeats):
        p_us = _gate_us_per_op(0, log_mib=log_mib)
        f_us = _gate_us_per_op(2, log_mib=log_mib)
        gate_plain.append(p_us)
        gate_full.append(f_us)
        pairs.append(100.0 * (f_us - p_us) / max(1e-12, p_us))
    pairs.sort()
    median = pairs[len(pairs) // 2]
    plain, full = [], []
    for _ in range(2):
        plain.append(_stress_seconds(0, threads=threads,
                                     total_mib=total_mib, log_mib=log_mib))
        full.append(_stress_seconds(2, threads=threads,
                                    total_mib=total_mib, log_mib=log_mib))
    cp = min(_hot_cpu_us_per_op(0) for _ in range(2))
    cf = min(_hot_cpu_us_per_op(2) for _ in range(2))
    return {
        "mode": "obs-overhead",
        "threads": threads,
        "us_per_op_plain": min(gate_plain),
        "us_per_op_obs2": min(gate_full),
        "overhead_pct": median,
        "overhead_pct_pairs": pairs,
        "samples_us_plain": gate_plain,
        "samples_us_obs2": gate_full,
        "stress_s_plain": min(plain),
        "stress_s_obs2": min(full),
        "stress_overhead_pct": 100.0 * (min(full) - min(plain))
            / max(1e-12, min(plain)),
        "hot_cpu_us_per_op_plain": cp,
        "hot_cpu_us_per_op_obs2": cf,
        "hot_cpu_overhead_pct": 100.0 * (cf - cp) / max(1e-12, cp),
    }


if __name__ == "__main__":
    import json
    print(json.dumps({"span_breakdown": run_span_breakdown(),
                      "obs_overhead": run_obs_overhead()}, indent=2))
