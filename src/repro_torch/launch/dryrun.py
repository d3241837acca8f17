"""One-card dry run: the one-card mode of ``repro.launch.dryrun`` (its
``make_single_mesh`` 1x1), for every (arch x shape) cell.

    python -m repro_torch.launch.dryrun --all --device cpu
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --batch 32

Each cell's step (``train_step``, ``prefill_step`` or ``serve_step`` of
``train/steps.py``, on the inputs of ``configs/shapes.py``) runs once on
``meta`` tensors: shapes and dtypes only, no memory, no data.  That run
gives the bytes of the state (parameters, and for a train cell the AdamW
moments, bf16 where the parameters are, as the JAX dry run sets them),
the inputs, the cache and the outputs, their sum ``resident_bytes``
(activations and temporaries not counted), whether that fits the card's
80 GB, and the FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts.
Attention and the SSD scan run as their plain versions on ``meta``
(``kernels/ops.py``), so those FLOPs count the plain versions' work: every
(query, key) score, the causal half included, and every chunk's
quadratic block.  Beside them, ``k1_flops`` counts K1's operations as
``chip_smoke.py``'s bound column does, over the visible (query, key) pairs
of each attention call the step makes, and its backward's where the step
trains.

With ``--device cuda`` the cell also runs on the card, once per ``--reps``
(each step timed on the host clock around synchronised work), at the
``--batch`` cut or, without one, at the full batch when it fits the card;
the record then has ``peak_bytes`` (``torch.cuda.max_memory_allocated``),
each step's ms and the hand-written kernels' launches, and with
``--profile`` one more step's device time by kernel and busy share.  No mesh and no
collectives: those come with the distribution slice.  One JSON record a
cell goes to ``--out`` (default ``build/dryrun``); the function
:func:`run_cell` returns it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import all_archs, get_config
from repro_torch.configs.shapes import (SHAPES, applicable, concrete_inputs, input_specs,
                                        scale_shape)
from repro_torch.kernels import ops
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.train import steps as tsteps

CARD_BYTES = 80 * 10**9          # one H100's 80 GB
TOP = 10                         # kernels a profiled card run lists
FLOPS_NOTE = ("FlopCounterMode over the meta run: attention and the SSD scan are counted "
              "as their plain versions compute them, every (query, key) score (the causal "
              "half included) and every chunk's quadratic block")


def optimizer_for(cfg) -> AdamW:
    """The JAX dry run's optimizer: bf16 moments where the parameters are bf16."""
    return AdamW(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)


def nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict / tuple / list."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible (query i sees keys
    up to i when causal, and only the last ``window`` of them with a
    window)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, i + 1) if causal else np.full(Sq, Skv, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else 0
    return int(np.maximum(0, hi - lo).sum())


@contextlib.contextmanager
def attention_calls():
    """Record every ``ops.flash_attention`` call as (shapes, causal, window,
    backward): ``backward`` True for a call whose inputs record a gradient
    and that runs outside the backward pass (a call the backward kernel
    will differentiate; a remat recompute runs inside the backward)."""
    calls, inner = [], ops.flash_attention

    def spy(q, k, v, *, causal=True, window=0, scale=None):
        in_backward = torch._C._current_autograd_node() is not None
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        calls.append({"q": tuple(q.shape), "k": tuple(k.shape), "v": tuple(v.shape),
                      "causal": causal, "window": window or 0,
                      "backward": grad and not in_backward})
        return inner(q, k, v, causal=causal, window=window, scale=scale)

    ops.flash_attention = spy
    try:
        yield calls
    finally:
        ops.flash_attention = inner


def k1_call_flops(B, Sq, Skv, H, D, Dv, causal, window, backward=False) -> int:
    """K1's operations in one call, over the visible (query, key) pairs:
    forward 2·B·H·(D + Dv) a pair (Q K^T over D, P V over Dv); backward
    2·B·H·(3D + 2Dv) a pair (S, dQ, dK over D; dP, dV over Dv).
    ``chip_smoke.py``'s bound column counts with it too."""
    per_pair = 3 * D + 2 * Dv if backward else D + Dv
    return 2 * B * H * per_pair * visible_pairs(Sq, Skv, causal, window)


def k1_flops(calls) -> int:
    """K1's operations over the recorded calls, the backward's too."""
    total = 0
    for c in calls:
        B, Sq, H, D = c["q"]
        args = (B, Sq, c["k"][1], H, D, c["v"][3], c["causal"], c["window"])
        total += k1_call_flops(*args)
        if c["backward"]:
            total += k1_call_flops(*args, backward=True)
    return total


def cell_args(model, shape, device):
    """(step, args, {state, inputs, cache} of ``args``) for the cell on
    ``device``: on meta the specs and the abstract state, elsewhere
    parameters drawn from seed 0 and ``concrete_inputs``."""
    cfg = model.cfg
    device = torch.device(device)
    meta = device.type == "meta"
    gen = torch.Generator("cpu" if meta else device).manual_seed(0)
    inputs = input_specs(cfg, shape) if meta else concrete_inputs(cfg, shape, device)
    if shape.kind == "train":
        opt = optimizer_for(cfg)
        state = (tsteps.abstract_train_state(model, opt) if meta
                 else tsteps.init_train_state(model, opt, gen))
        return tsteps.make_train_step(model, opt), (state, inputs), {
            "state": state, "inputs": inputs, "cache": None}
    params = model.init(gen, device)
    if shape.kind == "prefill":
        return tsteps.make_prefill_step(model, shape.seq), (params, inputs), {
            "state": params, "inputs": inputs, "cache": None}
    cache, tokens = inputs
    return tsteps.make_serve_step(model), (params, cache, tokens), {
        "state": params, "inputs": tokens, "cache": cache}


def _bytes_of(parts, out, kind):
    """{state, inputs, cache, outputs, resident}_bytes: a prefill's cache is
    the one it returns, a decode's the one it updates in place."""
    state, inputs = nbytes(parts["state"]), nbytes(parts["inputs"])
    if kind == "train":
        cache, outputs = 0, nbytes(out)
    elif kind == "prefill":
        cache, outputs = nbytes(out[1]), nbytes(out[0])
    else:
        cache, outputs = nbytes(parts["cache"]), nbytes(out[0])
    return {"state_bytes": state, "input_bytes": inputs, "cache_bytes": cache,
            "output_bytes": outputs, "resident_bytes": state + inputs + cache + outputs}


def counted_record(cfg, shape, device="meta") -> dict:
    """The cell's run under the FLOP counter, on meta (or, at small sizes,
    on the CPU): bytes, FLOPs, K1's calls and operations."""
    model = build(cfg)
    step, args, parts = cell_args(model, shape, device)
    t0 = time.perf_counter()
    with attention_calls() as calls, FlopCounterMode(display=False) as fc:
        out = step(*args)
    rec = _bytes_of(parts, out, shape.kind)
    rec.update(fits_one_card=rec["resident_bytes"] <= CARD_BYTES,
               flops=int(fc.get_total_flops()), flops_note=FLOPS_NOTE,
               flops_by_op={str(op): int(n) for op, n in
                            sorted(fc.get_flop_counts().get("Global", {}).items(), key=str)},
               k1_calls=len(calls), k1_backward_calls=sum(c["backward"] for c in calls),
               k1_flops=k1_flops(calls), counted_s=time.perf_counter() - t0)
    return rec


def _launches():
    """{kernel: launches} of the hand-written kernels' wrappers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize, ssd_scan
    return {"k1": fa.flash_attention_cuda.launches, "k1b": fa.flash_attention_bwd_cuda.launches,
            "k2": quantize.quantize_cuda.launches, "k3": ssd_scan.ssd_cuda.launches}


def card_record(cfg, shape, *, reps=1, profile=False) -> dict:
    """The cell run ``reps`` times on the card from parameters drawn from
    seed 0: each step's ms (host clock around synchronised work), the
    peak of allocated memory from before the state was made, and the
    kernels' launches over all the steps.  A decode cell steps on from its
    own cache, a train cell from its own state.  With ``profile`` one more
    step runs under ``torch.profiler``: its device time by kernel (the
    largest ``TOP``) and its device-busy share (device time over that
    step's wall time, the profiler's own cost included)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    step, args, parts = cell_args(model, shape, dev)
    before = _launches()
    times, finite = [], True
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        result = out["loss"] if shape.kind == "train" else out[0]
        finite &= bool(torch.isfinite(result).all())
        if shape.kind == "decode":
            args = (args[0], out[1], args[2])
    launches = {k: n - before[k] for k, n in _launches().items()}
    prof = _profiled(step, args) if profile else {}
    rec = {**prof, "step_ms": times, "ms": times[-1], "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(), "finite": finite,
           "outputs": (f"loss {float(out['loss']):.4f}, grad norm {float(out['grad_norm']):.4f}"
                       if shape.kind == "train" else f"logits {tuple(out[0].shape)}"),
           "output_shape": () if shape.kind == "train" else tuple(out[0].shape)}
    rec.update(_bytes_of(parts, out, shape.kind))
    del step, args, parts, out
    torch.cuda.empty_cache()
    return rec


def _profiled(step, args) -> dict:
    """One more step under the profiler: {profile_ms, device_ms, busy,
    top_kernels}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _device_ms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_ms(prof)
    device = sum(ms for _, ms in rows)
    return {"profile_ms": wall, "device_ms": device, "busy": device / wall,
            "top_kernels": [[name[:120], ms] for name, ms in rows[:TOP]]}


def run_cell(arch: str, shape_name: str, *, device="cuda", batch: int = 0, reps: int = 1,
             profile: bool = False) -> dict:
    """The record of one cell: ``status`` ``ok``, ``skipped`` (with
    ``applicable``'s reason) or ``error``; ``params`` and ``active_params``;
    the full shape's meta run (:func:`counted_record`); and with ``device``
    cuda the card's run (:func:`card_record`) at the ``batch`` cut (0: the
    full batch, run only when it fits the card) under ``"card"``."""
    cfg = get_config(arch)
    full = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "1x1", "kind": full.kind,
           "seq": full.seq, "batch": full.batch,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    ok, reason = applicable(cfg, full)
    if not ok:
        return {**rec, "status": "skipped", "reason": reason}
    try:
        rec.update(counted_record(cfg, full))
        rec["status"] = "ok"
        if torch.device(device).type == "cuda" and (batch or rec["fits_one_card"]):
            cut = scale_shape(full, batch=batch)
            rec["card"] = {"batch": cut.batch,
                           **card_record(cfg, cut, reps=reps, profile=profile)}
    except Exception as e:   # recorded per cell, as the JAX dry run records it
        rec.update(status="error", error=repr(e), traceback=traceback.format_exc())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda: also run each cell on the card; cpu: the meta run only")
    ap.add_argument("--batch", type=int, default=0, help="the card run's batch cut")
    ap.add_argument("--reps", type=int, default=1, help="steps the card run takes")
    ap.add_argument("--profile", action="store_true",
                    help="one more card step under torch.profiler: device time by kernel")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = all_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, device=args.device, batch=args.batch, reps=args.reps,
                           profile=args.profile)
            tag = f"{arch}__{shape}__1x1"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                extra = (f" resident={rec['resident_bytes'] / 2**30:.2f}GiB"
                         f" fits={rec['fits_one_card']} flops={rec['flops']:.3e}"
                         f" k1_flops={rec['k1_flops']:.3e}")
                if "card" in rec:
                    card = rec["card"]
                    extra += (f" card: batch {card['batch']} {card['ms']:.2f} ms peak "
                              f"{card['peak_bytes'] / 2**30:.2f}GiB launches {card['launches']}")
                    if "busy" in card:
                        extra += (f" device {card['device_ms']:.2f} ms busy {card['busy']:.3f}; "
                                  + "; ".join(f"{n[:60]} {ms:.2f}" for n, ms in
                                              card["top_kernels"][:6]))
            elif rec["status"] == "error":
                failures += 1
                extra = " " + rec["error"][:200]
            else:
                extra = " " + rec["reason"]
            print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
