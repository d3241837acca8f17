"""moe_roofline_pct.serve: the least time of the held experts' grouped
products in the window's prefills (``work.moe.moe_work`` at each prefill's
batch times prompt length, times the model's MoE blocks, bf16) over the
device time of the kernels that compute them (``torch._grouped_mm``'s
CUDA kernels, by name) that ran in those prefills, in percent.  A
prefill's device work lies between its ``serve.prefill`` range's start
and the next ``serve.decode_step`` range's (the host reads the first
token in between, which waits for the prefill); the decode steps' grouped
products, replayed in CUDA graphs, are left out of both sides.  None
where no such kernel ran, or for a model with no MoE block.

The least time counts the pairs a prefill is expected to put on the held
experts (tokens · k · held / router experts), not the pairs it routed
there: the routed count is a device tensor of the program's that the
trace does not hold.  The held share of the pairs read 0.482-0.503 over
four seeds at a 16 x 8192 prefill (NVIDIA H100 80GB HBM3), so the share
moves by up to about 4% with the seed's routing, beside the kernel's own
change."""
from __future__ import annotations

import bisect

from bench.harness import spans
from bench.work.moe import moe_work
from bench.work.peaks import bound_s

# torch._grouped_mm's kernels on sm90 (NVIDIA H100 80GB HBM3, torch 2.11): its
# CUTLASS grouped GEMM (mangled name) and the kernel that lays out its problems
GROUPED = ("GroupProblemShape", "prepare_grouped_gemm_data")


def prefill_windows(trace):
    """[start, end) on the trace's clock of each prefill's device work."""
    steps = [s for s, _ in spans.named(trace, "serve.decode_step")]
    out = []
    for s, _ in spans.named(trace, "serve.prefill"):
        i = bisect.bisect_right(steps, s)
        out.append((s, steps[i] if i < len(steps) else trace.t1))
    return out


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or tr is None or not run["batches"]:
        return None
    m = run["conf"]["model"]
    blocks = m.get("block_pattern", "").count("E")
    if not blocks:
        return None
    windows = prefill_windows(tr)
    starts = [s for s, _ in windows]

    def in_prefill(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < windows[i][1]

    kernel_ns = sum(e - s for s, e, n in tr.device
                    if any(k in n for k in GROUPED) and in_prefill(s))
    if kernel_ns <= 0:
        return None
    least = sum(blocks * bound_s(*moe_work(m, len(b["tokens"]) * b["P"]))[0]
                for b in run["batches"])
    return 100.0 * least / (kernel_ns / 1e9)
