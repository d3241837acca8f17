"""Roofline of the dry run's records on H100 constants: the port of
``benchmarks/roofline.py``, and the one home of the card's peak rates and
of the hand-written kernels' own work.

    python -m repro_torch.launch.roofline [--mesh 1x1|single|multi] [--dir build/dryrun]

For each ``ok`` record of ``launch/dryrun.py`` (``build/dryrun/*.json``)
three terms, in seconds a step on one device:

  * ``t_compute``: ``work_flops`` by dtype over that dtype's peak;
  * ``t_memory``: ``work_hbm_bytes`` over the HBM rate;
  * ``t_collective``: each mesh group's wire bytes over its link (0 at
    1x1), the groups taken one after another.

``work_*`` count the three kernels as units (their own operations and
bytes, :func:`attention_work`, :func:`attention_bwd_work`,
:func:`ssd_work`, :func:`quantize_work`) and every other op of the step as
it runs; so the terms read the same work whatever implements a kernel.
``chip_smoke.py``'s bound column calls the same functions.  Then the
``bottleneck`` (the largest term), ``model_flops`` (JAX's 6·N·D for a
train step, 2·N·D to serve, over the record's own batch and devices),
``useful_ratio`` (model over work FLOPs) and ``roofline_fraction`` (the
model FLOPs' time at the bf16 peak over the largest term).  A record with
a card run (``--device cuda``) also gets ``roofline_fraction_measured``:
the cut's bound (the larger of its compute and memory terms) over its
fastest measured step.  The table goes to stdout, the table and a CSV to
``build/``.

Constants, for one NVIDIA H100 SXM 80GB: 989 TFLOP/s dense bf16 on the
tensor cores, 67 TFLOP/s fp32 on the CUDA cores (the port turns TF32
off), 3.35 TB/s HBM3.  The links are datasheet figures, measured by no
chip run of this repo: NVLink 4 between the 8 cards of a node, 450 GB/s a
direction (900 GB/s both ways); one 400 Gb/s NDR InfiniBand port a card
between nodes, 50 GB/s.  Ranks are numbered row-major over the mesh and
a node holds 8 consecutive ranks, so on the 16x16 mesh the ``model`` axis
(16 wide) and every ``data`` group span nodes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from repro_torch.configs.shapes import SHAPES

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": PEAK_F32_FLOPS}
NVLINK_BYTES = 450e9          # NVLink 4, one direction (datasheet)
NDR_BYTES = 50e9              # one 400 Gb/s NDR port a card (datasheet)
NODE_CARDS = 8

# tokens a step of each assigned shape at its full batch (JAX's SHAPE_TOKENS)
SHAPE_TOKENS = {
    "train_4k": ("train", 4096 * 256),
    "prefill_32k": ("prefill", 32768 * 32),
    "decode_32k": ("decode", 128),
    "long_500k": ("decode", 1),
}


# ------------------------------------------------------------ kernel work

def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible (query i sees keys
    up to i when causal, and only the last ``window`` of them with a
    window)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, i + 1) if causal else np.full(Sq, Skv, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else 0
    return int(np.maximum(0, hi - lo).sum())


def k1_call_flops(B, Sq, Skv, H, D, Dv, causal, window, backward=False) -> int:
    """K1's operations in one call, over the visible (query, key) pairs:
    forward 2·B·H·(D + Dv) a pair (Q K^T over D, P V over Dv); backward
    2·B·H·(3D + 2Dv) a pair (S, dQ, dK over D; dP, dV over Dv)."""
    per_pair = 3 * D + 2 * Dv if backward else D + Dv
    return 2 * B * H * per_pair * visible_pairs(Sq, Skv, causal, window)


def attention_work(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window):
    """(operations, bytes) of one K1 call: :func:`k1_call_flops`, and q, k
    (D), v and o (Dv) read once and written once."""
    flops = k1_call_flops(B, Sq, Skv, H, D, Dv, causal, window)
    return flops, itemsize * (B * Sq * H * (D + Dv) + B * Skv * KV * (D + Dv))


def attention_bwd_work(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window):
    """(operations, bytes) of one K1 backward: five products a visible
    pair; q, dO, o, k, v and the float32 log-sum-exp read once, dq, dk,
    dv written once."""
    flops = k1_call_flops(B, Sq, Skv, H, D, Dv, causal, window, backward=True)
    nbytes = (itemsize * (2 * B * Sq * H * (D + Dv) + 2 * B * Skv * KV * (D + Dv))
              + 4 * B * H * Sq)
    return flops, nbytes


def ssd_work(b, s, h, p, g, n, chunk, itemsize):
    """(operations, bytes) of one SSD scan.  Operations: C B^T over each
    chunk's causal triangle once per (batch, group, chunk), then per
    (batch * head, chunk) (C B^T . L)(x dt) over the triangle, C S^T and
    the state update.  Bytes: x, dt (f32), A, B, C read once, y and the
    final f32 state written once."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = b * g * nc * 2 * tri * n + b * h * nc * (2 * tri * p + 2 * 2 * chunk * p * n)
    nbytes = (2 * b * s * h * p * itemsize + 4 * b * s * h + 4 * h
              + 2 * b * s * g * n * itemsize + 4 * b * h * p * n)
    return flops, nbytes


def quantize_work(n, group, itemsize):
    """(operations, bytes) of one int8 group quantize of n values: each
    value read once and written once as int8, one float32 scale per group.
    Its few operations a value are elementwise, which no term counts for
    any op (``flop_registry`` counts products), so 0."""
    return 0, n * itemsize + n + 4 * (n // group)


def bound_ms(flops, nbytes, peak_flops):
    """(ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window, peak_flops):
    """Least time (ms) for one attention call, and what bounds it."""
    return bound_ms(*attention_work(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window),
                    peak_flops)


def attention_bwd_bound(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window, peak_flops):
    """Least time (ms) for one attention backward, and what bounds it."""
    return bound_ms(*attention_bwd_work(B, Sq, Skv, H, KV, D, Dv, itemsize, causal, window),
                    peak_flops)


def ssd_bound(b, s, h, p, g, n, chunk, itemsize, peak_flops):
    """Least time (ms) for one SSD scan, and what bounds it."""
    return bound_ms(*ssd_work(b, s, h, p, g, n, chunk, itemsize), peak_flops)


def quantize_bound(n, group, itemsize):
    """Least time (ms) for one int8 group quantize: its bytes bound it."""
    return bound_ms(*quantize_work(n, group, itemsize), PEAK_BF16_FLOPS)


# ------------------------------------------------------------------ terms

def link_bytes(ranks) -> float:
    """Bytes/s of the link a group of ``ranks`` crosses: NVLink when all
    lie in one node of ``NODE_CARDS``, else one NDR port a card."""
    return NVLINK_BYTES if len({r // NODE_CARDS for r in ranks}) == 1 else NDR_BYTES


def model_flops(rec: dict) -> float:
    """JAX's analytic 6·N·D (train) or 2·N·D (serve) a device, D the
    tokens of the record's own batch (``SHAPE_TOKENS`` at the full one)."""
    kind, tokens = SHAPE_TOKENS[rec["shape"]]
    tokens = tokens * rec["batch"] // SHAPES[rec["shape"]].batch
    return (6 if kind == "train" else 2) * rec["active_params"] * tokens / rec["devices"]


def terms(rec: dict) -> dict:
    """{t_compute, t_memory, t_collective} of a record's counts (s)."""
    t_compute = sum(n / PEAK_FLOPS.get(dt, PEAK_F32_FLOPS)
                    for dt, n in rec["work_flops_by_dtype"].items())
    t_collective = sum(g["wire_bytes"] / link_bytes(g["ranks"])
                       for g in rec.get("groups", {}).values())
    return {"t_compute": t_compute, "t_memory": rec["work_hbm_bytes"] / PEAK_BYTES,
            "t_collective": t_collective}


def bound_s(counts: dict) -> float:
    """A card run's bound (s): the larger of the compute and memory terms
    of its cut's counts (one card: no collective)."""
    t = terms(counts)
    return max(t["t_compute"], t["t_memory"])


def analyze(rec: dict) -> dict:
    """``rec`` with its roofline fields (an ``ok`` record; others as
    they are)."""
    if rec["status"] != "ok":
        return rec
    out = {**rec, **terms(rec)}
    named = {"compute": out["t_compute"], "memory": out["t_memory"],
             "collective": out["t_collective"]}
    out["bottleneck"] = max(named, key=named.get)
    out["model_flops"] = model_flops(rec)
    out["useful_ratio"] = out["model_flops"] / max(rec["work_flops"], 1)
    t_step = max(named.values())
    out["roofline_fraction"] = out["model_flops"] / PEAK_BF16_FLOPS / t_step if t_step else 0.0
    card = rec.get("card")
    if card:
        out["card_bound_s"] = bound_s(card["count"])
        out["card_min_s"] = min(card["step_ms"]) / 1e3
        out["roofline_fraction_measured"] = out["card_bound_s"] / out["card_min_s"]
    return out


def table(directory: str = "build/dryrun", mesh: str = "1x1") -> list:
    """The analysed records of ``mesh`` in ``directory``, by tag."""
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, f"*__{mesh}.json"))):
        with open(path) as f:
            rows.append(analyze(json.load(f)))
    return rows


def fmt_table(rows) -> str:
    """A markdown table of :func:`table`'s rows."""
    lines = ["| arch | shape | devices | t_compute s | t_memory s | t_coll s | bottleneck "
             "| MODEL/work flops | roofline frac | card: bound / measured |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('devices', '')} | — | — | — "
                         f"| {r['status']} | — | — | — |")
            continue
        measured = (f"{r['card_bound_s']:.4g} / {r['card_min_s']:.4g} s = "
                    f"{r['roofline_fraction_measured']:.3f} (batch {r['card']['batch']})"
                    if "card" in r else "—")
        lines.append(f"| {r['arch']} | {r['shape']} | {r['devices']} | {r['t_compute']:.4g} | "
                     f"{r['t_memory']:.4g} | {r['t_collective']:.4g} | {r['bottleneck']} | "
                     f"{r['useful_ratio']:.3f} | {r['roofline_fraction']:.3f} | {measured} |")
    return "\n".join(lines)


CSV_KEYS = ("arch", "shape", "status", "devices", "t_compute", "t_memory", "t_collective",
            "bottleneck", "useful_ratio", "roofline_fraction", "work_flops", "work_hbm_bytes",
            "wire_bytes", "model_flops", "roofline_fraction_measured")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="all", choices=("1x1", "single", "multi", "all"))
    ap.add_argument("--dir", default="build/dryrun", help="the dry run's records")
    ap.add_argument("--out", default="build", help="where the tables and CSVs go")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for mesh in ("1x1", "single", "multi") if args.mesh == "all" else (args.mesh,):
        rows = table(args.dir, mesh)
        if not rows:
            continue
        text = fmt_table(rows)
        print(f"## {mesh}\n\n{text}\n")
        with open(os.path.join(args.out, f"roofline_{mesh}.md"), "w") as f:
            f.write(text + "\n")
        with open(os.path.join(args.out, f"roofline_{mesh}.csv"), "w") as f:
            f.write(",".join(CSV_KEYS) + "\n")
            for r in rows:
                f.write(",".join("" if r.get(k) is None else str(r.get(k)) for k in CSV_KEYS)
                        + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
