"""Dual persistence engine (PR 7): paged NVMM frames vs the append log.

Two measurements:

* ``run_bytes_per_committed`` — an overwrite-heavy stream (several full
  passes over a file that fits the paged region) measured as TOTAL
  persisted bytes per committed byte: NVMM stored bytes plus backend
  bytes.  The log persists every overwrite twice — an entry appended to
  NVMM, then the drain's page write to the backend — so N passes cost
  ~2N page images.  A frame persists each overwrite once (in place, plus
  a 64-byte header flip) and pays the backend exactly one final image at
  writeback.  Acceptance: the paged engine persists >= 1.5x fewer bytes
  per committed byte.

* ``run_trickle_parity`` — the fig9 trickle workload (``batch_min=1``,
  small sequential writes with think-time gaps) run with the classifier
  armed: small-write streams must stay in log mode, keeping trickle
  throughput within 5% of the PR-5 tip.
"""
from __future__ import annotations

import time

from repro_torch.launch.engine_bench.backends import make_stack
from repro_torch.core.policy import CACHELINE

PAGE = 4096


def run_bytes_per_committed(n_pages: int = 32, passes: int = 8):
    """Overwrite ``n_pages`` full pages ``passes`` times (after one warmup
    pass that lets the classifier flip and the warmup entries drain);
    report steady-state persisted bytes (NVMM + backend) per committed
    byte for log vs paged mode."""
    rows = []
    for mode in ("log", "paged"):
        # eager-durability regime (the acceptance context): batch_min=1
        # drains per tiny batch, and batch_max < n_pages means a batch can
        # never span a full pass — so cross-pass overwrite coalescing
        # cannot mask the log's backend churn nondeterministically
        st = make_stack(
            "nvcache+ssd", log_mib=1, batch_min=1, batch_max=n_pages // 2,
            page_frames=2 * n_pages if mode == "paged" else 0,
            classify_window=8)
        try:
            fd = st.fs.open("/hot.dat")
            for p in range(n_pages):            # warmup pass: classifier
                st.fs.pwrite(fd, b"\x00" * PAGE, p * PAGE)
            st.nv.flush()                       # ...flips, refs drain
            tf = st.tier.open("/hot.dat")
            nvmm0 = st.nv.nvmm.stats_stored_bytes
            s0 = st.nv.stats()
            backend0 = tf.stats_bytes
            committed = 0
            t0 = time.perf_counter()
            for rnd in range(passes):
                buf = bytes([rnd + 1]) * PAGE
                for p in range(n_pages):
                    st.fs.pwrite(fd, buf, p * PAGE)
                    committed += PAGE
            st.nv.flush()
            dt = time.perf_counter() - t0
            s = st.nv.stats()
            nvmm_bytes = st.nv.nvmm.stats_stored_bytes - nvmm0
            backend_bytes = tf.stats_bytes - backend0
            persisted = nvmm_bytes + backend_bytes
            pwbs = s["nvmm_pwbs"] - s0["nvmm_pwbs"]
            flushed = CACHELINE * (s["nvmm_pwb_lines"] - s0["nvmm_pwb_lines"])
            psyncs = s["nvmm_psyncs"] - s0["nvmm_psyncs"]
            # reconcile the flush counters against the persisted-bytes
            # figure: every NVMM-stored byte must be covered by a pwb
            # (lower bound), and pwb traffic may exceed stores only by
            # per-call partial-line rounding (upper bound) — a redundant
            # or missing flush in a commit path moves one of these.
            assert nvmm_bytes <= flushed <= nvmm_bytes + 2 * CACHELINE * pwbs, \
                (mode, nvmm_bytes, flushed, pwbs)
            assert psyncs > 0, "no durability points recorded"
            rows.append({
                "mode": mode,
                "committed_bytes": committed,
                "nvmm_stored_bytes": nvmm_bytes,
                "backend_bytes": backend_bytes,
                "persisted_bytes": persisted,
                "persisted_per_committed_byte": persisted / committed,
                "nvmm_pwbs": pwbs,
                "flushed_bytes": flushed,
                "flushed_per_committed_byte": flushed / committed,
                "nvmm_psyncs": psyncs,
                "mode_migrations": s["mode_migrations"],
                "paged_frame_writes": s["paged_frame_writes"],
                "paged_writebacks": s["paged_writebacks"],
                "log_full_scans": s["log_full_scans"],
                "seconds": dt,
            })
        finally:
            st.close()
        print(f"fig_dualmode/{mode},persisted/committed="
              f"{rows[-1]['persisted_per_committed_byte']:.2f},"
              f"nvmm={rows[-1]['nvmm_stored_bytes']},"
              f"backend={rows[-1]['backend_bytes']}", flush=True)
    return rows


def run_trickle_parity(n_writes: int = 192, bs: int = 1024,
                       gap_s: float = 0.002):
    """fig9's trickle with the dual engine armed: the classifier must keep
    a small-write stream on the log, so throughput matches the PR-5 tip."""
    rows = []
    for mode in ("pr5-tip", "dual-engine"):
        st = make_stack(
            "nvcache+ssd", log_mib=2, batch_min=1, batch_max=500,
            span_batches=True, deadline_ms=100.0,
            page_frames=64 if mode == "dual-engine" else 0,
            classify_window=32)
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
            s = st.nv.stats()
            rows.append({
                "mode": mode,
                "writes": n_writes, "bs": bs,
                "seconds": dt,
                "us_per_write": 1e6 * dt / n_writes,
                "mode_migrations": s["mode_migrations"],
                "paged_frame_writes": s["paged_frame_writes"],
            })
        finally:
            st.close()
        print(f"fig_dualmode/trickle_{mode},{1e6 * dt / n_writes:.1f}us/write,"
              f"migrations={rows[-1]['mode_migrations']}", flush=True)
    return rows


if __name__ == "__main__":
    run_bytes_per_committed()
    run_trickle_parity()
