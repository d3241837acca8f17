#!/usr/bin/env python3
"""Chip check of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   every kernel of the serving and training paths from
             ``src/repro_torch/csrc``, one ``nvcc`` per source, all started
             together;
  2. kernels each kernel (K1 flash attention and its backward, K2 int8
             quantize, K3 SSD scan) against its plain PyTorch version on the
             card, on the sweep of the CPU tests, at every shape the later
             phases drive it at and, for K1, at bf16 head dim 128, with its
             time at its main path's shape beside the plain version's, a
             library call's (where one PyTorch call computes the same) and
             the card's bound; two K1 backward runs must agree (dq adds with
             atomics); K1's times and the library's are taken in turns, with
             those of an earlier commit's K1 sources when they are copied
             into build/parent/;
  3. serve   llama3.2-1b, then mamba2-780m, at full width (batch 4, prompt
             2048, 32 new tokens) through ``repro_torch.launch.serve.main``,
             with the kernels' launch counts set to 0 just before and read
             just after each run, and the request log read back through the
             port's NVCacheFS;
  4. decode  teacher-forced decode against the full-sequence forward at full
             width, for each model, in float32 and in bfloat16;
  5. train   llama3.2-1b at full width (batch 4 x 2048, bf16 compute, f32
             parameters, AdamW, int8-compressed gradients) for a few steps
             through ``init_train_state``/``make_train_step``, with exact
             launch counts per step and a falling loss; then the training
             loop at SMOKE size through ``repro_torch.launch.train.main``,
             and a crash, NVMM-log recovery and resume that lands on the
             exact step.
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when there is no CUDA card or a phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
ARCHS = {"llama3.2-1b": "k1", "mamba2-780m": "k3"}   # each model's serving kernel
SLICE = dict(B=4, Sq=2048, Skv=2048, H=32, KV=8, D=64)   # llama3.2-1b prefill, batch 4
SWEEP = [(B, Sq, Skv, H, KV, D, dtype, causal, window)
         for B, Sq, Skv, H, KV, D in [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
                                      (1, 48, 96, 4, 1, 64)]
         for dtype in ("float32", "bfloat16")
         for causal, window in [(True, None), (False, None), (True, 24)]]
# the shapes the phases below drive K1 at: serve's prefill, then the decode
# phase's forward over 64 tokens and its prefill of one token, in both dtypes
MODEL_CASES = [(*SLICE.values(), "bfloat16", True, None)] + [
    (1, S, S, 32, 8, 64, dtype, True, None)
    for S in (64, 1) for dtype in ("float32", "bfloat16")]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the bf16 wgmma kernels' other head dim, forward and backward: several full
# 128-row tiles, and a window
D128_CASES = [(2, 2048, 2048, 16, 4, 128, "bfloat16", True, None),
              (2, 200, 200, 8, 2, 128, "bfloat16", True, 24)]
# The attention sources of an earlier commit, when they are stashed here
# (build/ is not committed): phase 2 then times them beside the kernels of
# this tree and the library call, in turns, in this one process.
PARENT_DIR = Path(__file__).resolve().parent / "build" / "parent"
# K1 backward (dq, dk, dv against autograd of attention_ref), the same form
# |d| <= tol·(1+|ref|): f32 sums in another order; bf16 rounds P and dS as
# tensor-core operands and dq/dk/dv once at the end
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the shapes the train phases drive the backward at: the full-width step
# and the SMOKE loop (batch 2, seq 64, 4 heads on 2 kv heads of 16)
TRAIN = dict(B=4, Sq=2048, Skv=2048, H=32, KV=8, D=64)
BWD_CASES = [(*TRAIN.values(), "bfloat16", True, None),
             (2, 64, 64, 4, 2, 16, "bfloat16", True, None),
             (2, 32, 32, 4, 2, 16, "bfloat16", True, None)]
TRAIN_STEPS = 4
# Adam's first steps move every weight by about lr, so a layer's output
# moves by about lr * d_model: at d_model 2048, lr 1e-3 (SMOKE's, d_model 64)
# sent the loss from 12.0 up to 25.0 in 3 steps on an H100.  1e-5 keeps the
# change per layer near 2%.
TRAIN_LR = 1e-5
# K2: the CPU tests' cases (with an all-zero group and exact .5 ties), then
# every gradient leaf of the full-width step, flattened and padded to the
# group as compress_tree hands them over; held to equality
QUANT_CASES = [((64, 512), 256), ((3, 5, 256), 128), ((1024,), 256)]
# K3: mamba2-780m prefill, batch 4 (b, s, h, p, g, n, chunk)
SSD_SLICE = dict(b=4, s=2048, h=48, p=64, g=1, n=128, chunk=256)
SSD_SWEEP = [(*shape, dtype)
             for shape in [(1, 32, 2, 8, 1, 8, 8), (2, 64, 4, 16, 2, 16, 16),
                           (1, 128, 4, 32, 1, 32, 32)]
             for dtype in ("float32", "bfloat16")]
# the shapes the phases below drive K3 at: serve's prefill, then the decode
# phase's forward over 64 tokens (chunk 64) and its prefill of one token
SSD_MODEL_CASES = [(*SSD_SLICE.values(), "bfloat16")] + [
    (1, S, 48, 64, 1, 128, S, dtype) for S in (64, 1) for dtype in ("float32", "bfloat16")]
SSD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # y; the float32 state is held to 2e-3
# max |logit| gap, 64 tokens: float32 sums in another order; bfloat16
# re-rounding of the residual stream over the layers
DECODE_TOL = {"float32": 2e-3, "bfloat16": 0.25}
# Random-weight mamba2 amplifies bfloat16 rounding with depth, in the JAX
# model as in the port (tests/test_torch_lm.py::
# test_mamba2_decode_gap_tracks_jax_with_depth), so no fixed bound on its
# bfloat16 decode-vs-forward gap holds at 48 layers; its float32 gap, held to
# DECODE_TOL, is what catches a fault in decode.  Its bfloat16 decode is held
# to the bfloat16 forward's own rounding noise instead: mean |decode -
# forward| at most mean |bfloat16 forward - float32 forward|, same weights
# and tokens.  In float32 the gap of a forward through the plain scan is
# printed beside it: how far the chunked algorithm itself sits from the
# recurrence.
NOISE_HELD = {"mamba2-780m"}


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(torch, fns, reps):
    """Mean device time (ms) of each named function, timed in the order
    a, b, ..., ..., b, a; returns {name: [first, second]}."""
    times = {name: [] for name, _ in fns}
    for name, fn in fns + fns[::-1]:
        times[name].append(cuda_ms(torch, fn, reps))
    return times


def visible_pairs(Sq, Skv, causal, window):
    """The (query, key) pairs the masks leave visible."""
    pairs = 0
    for i in range(Sq):
        hi = min(Skv, i + 1) if causal else Skv
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def attention_bound(B, Sq, Skv, H, KV, D, itemsize, causal, window, peak_flops):
    """Least time (ms) for one attention call: the larger of the operations
    the visible (query, key) pairs need over the peak rate and the bytes of
    q, k, v read once and o written once over the memory rate."""
    flops = 4 * B * H * D * visible_pairs(Sq, Skv, causal, window)
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Skv * KV * D)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bound(b, s, h, p, g, n, chunk, itemsize, peak_flops):
    """Least time (ms) for one SSD scan: the larger of the operations over
    the peak rate and the bytes of x, dt, A, B, C read once and of y and the
    final state written once over the memory rate.  Operations: C B^T over
    each chunk's causal triangle once per (batch, group, chunk), then per
    (batch * head, chunk) (C B^T . L)(x dt) over the triangle, C S^T and
    the state update."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = b * g * nc * 2 * tri * n + b * h * nc * (2 * tri * p + 2 * 2 * chunk * p * n)
    nbytes = (2 * b * s * h * p * itemsize + 4 * b * s * h + 4 * h
              + 2 * b * s * g * n * itemsize + 4 * b * h * p * n)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bwd_bound(B, Sq, Skv, H, KV, D, itemsize, causal, window, peak_flops):
    """Least time (ms) for one attention backward: five products (S, dP,
    dV, dQ, dK) of 2·D flops per visible pair, 2.5x the forward's, against
    the bytes of q, k, v, o, dO and the float32 log-sum-exp read once and
    dq, dk, dv written once."""
    flops = 10 * B * H * D * visible_pairs(Sq, Skv, causal, window)
    # read q, o, dO and write dq: 4 (B, Sq, H, D); read k, v and write dk, dv
    nbytes = itemsize * (4 * B * Sq * H * D + 4 * B * Skv * KV * D) + 4 * B * H * Sq
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_leaf_shapes(cfg):
    """The parameter (and so gradient) leaves of a dense model, by their
    checkpoint keys: what ``compress_tree`` quantizes, one K2 launch each."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"embed": (cfg.vocab, d), "final_norm": (d,),
            "layers/attn/wk": (L, d, kv), "layers/attn/wo": (L, q, d),
            "layers/attn/wq": (L, d, q), "layers/attn/wv": (L, d, kv),
            "layers/mlp/wd": (L, f, d), "layers/mlp/wg": (L, d, f), "layers/mlp/wu": (L, d, f),
            "layers/norm1": (L, d), "layers/norm2": (L, d)}


def quantize_bound(n, group, itemsize):
    """Least time (ms) for one int8 group quantize of n values: each value
    read once and written once as int8, one float32 scale per group; about
    three operations per byte, so the bytes bound it."""
    return (n * itemsize + n + 4 * (n // group)) / PEAK_BYTES * 1e3, "bytes"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.core import NVCache, Policy, recover
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW
    from repro_torch.storage.fsapi import NVCacheFS
    from repro_torch.storage.tiers import DRAM, Tier
    from repro_torch.train import loop as train_loop
    from repro_torch.train import steps as tsteps

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:74", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}
    # the JAX package has no attention backward kernel (it differentiates
    # its plain attention): the backward replaces that autodiff
    k1b = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers.py:79 (autodiff of blocked_attention)",
           "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None}
    k2 = {"name": "quantize_int8", "route": "cuda", "source": "src/repro_torch/csrc/quantize.cu",
          "replaces": "src/repro/kernels/quantize.py:54", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}   # no single PyTorch call group-quantizes
    k3 = {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
          "replaces": "src/repro/kernels/ssd_scan.py:68", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}   # no single PyTorch call scans SSD
    kernels = {"k1": (k1, fa.flash_attention_cuda), "k1b": (k1b, fa.flash_attention_bwd_cuda),
               "k2": (k2, quant.quantize_cuda), "k3": (k3, ssd.ssd_cuda)}
    for entry, _ in kernels.values():
        entry["paths"] = {}     # launches on each path the phases below drive

    def zero_counts():
        for _, fn in kernels.values():
            fn.launches = 0

    def read_counts(path):
        counts = {key: fn.launches for key, (_, fn) in kernels.items()}
        for key, (entry, _) in kernels.items():
            if counts[key]:
                entry["paths"][path] = counts[key]
        return counts

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as exc:   # report every phase, fail at the end
            traceback.print_exc()
            failures.append(f"{name}: {exc!r}")
            print(f"[{name}] FAILED: {exc!r}", flush=True)

    parent = {}   # entry-point name in fa -> the stashed earlier kernel's entry point

    def with_entry(name, entry, call):
        """``call`` with fa's library entry ``name`` pointing at ``entry``."""
        def run():
            saved = getattr(fa, name)
            setattr(fa, name, lambda: entry)
            try:
                return call()
            finally:
                setattr(fa, name, saved)
        return run

    # ---------------------------------------------------------------- build
    def build_kernels():
        t0 = time.perf_counter()
        builders = [fa.build, fa.build_bwd, quant.build, ssd.build]
        stashed = [PARENT_DIR / name for name in ("flash_attention.cu", "flash_attention_bwd.cu")]
        if all(src.exists() for src in stashed):
            builders += [lambda src=src: _build.build(src) for src in stashed]
        with ThreadPoolExecutor(len(builders)) as pool:   # one nvcc per source, together
            libs = list(pool.map(lambda build_one: build_one(), builders))
        if len(libs) > 4:
            parent["_entry"], parent["_bwd_entry"] = fa.load_fwd(libs[4]), fa.load_bwd(libs[5])
            print(f"  stashed earlier attention kernels from {PARENT_DIR}")
        print(f"build: {', '.join(lib.name for lib in libs)} in "
              f"{time.perf_counter() - t0:.2f} s")
        for lib in libs:
            log = Path(f"{lib}.log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "Used" in line or "spill" in line or "Compiling entry" in line:
                        print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    phase("build", build_kernels)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -------------------------------------------------------------- kernels
    def check_kernels():
        gen = torch.Generator(dev).manual_seed(0)
        bad, errs = [], {}
        for case in SWEEP + MODEL_CASES + D128_CASES:
            B, Sq, Skv, H, KV, D, dtype, causal, window = case
            dt = getattr(torch, dtype)
            q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
            k = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dt)
            v = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dt)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window or 0)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            errs[case] = float(diff.max())
            ok = bool((diff <= TOL[dtype] * (1 + want.float().abs())).all())
            print(f"  K1 B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} {dtype} causal={causal} "
                  f"window={window}: max_abs_err={errs[case]:.3e} tol={TOL[dtype]} "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case == MODEL_CASES[0]:
                slice_qkv = q, k, v
        k1["max_abs_err"] = errs[MODEL_CASES[0]]   # at the serving prefill shape
        q, k, v = slice_qkv
        scale = 1.0 / SLICE["D"] ** 0.5
        G = SLICE["H"] // SLICE["KV"]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        fns = [("kernel", lambda: fa.flash_attention_cuda(q, k, v, causal=True)),
               ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                scale=scale))]
        if parent:
            fns.append(("earlier kernel", with_entry("_entry", parent["_entry"], fns[0][1])))
        times = in_turns(torch, fns, 20)
        k1["ms"] = sum(times["kernel"]) / 2
        k1["library_ms"] = sum(times["sdpa"]) / 2
        if parent:
            k1["earlier_ms"] = sum(times["earlier kernel"]) / 2
        k1["plain_ms"] = cuda_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True), 5)
        k1["bound_ms"], k1["bound_by"] = attention_bound(
            *SLICE.values(), 2, True, 0, PEAK_BF16_FLOPS)
        print(f"  K1 at {SLICE} bf16 causal, in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f"; plain {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
              f"({k1['bound_by']})")
        if bad:
            raise AssertionError(f"K1 disagrees with attention_ref in {bad}")

    def check_ssd():
        gen = torch.Generator(dev).manual_seed(0)
        bad, errs = [], {}
        for case in SSD_SWEEP + SSD_MODEL_CASES:
            b, s, h, p, g, n, chunk, dtype = case
            cdt = getattr(torch, dtype)
            x = torch.randn((b, s, h, p), generator=gen, device=dev).to(cdt)
            dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
            A = -torch.randn((h,), generator=gen, device=dev).exp()
            B = torch.randn((b, s, g, n), generator=gen, device=dev).to(cdt)
            C = torch.randn((b, s, g, n), generator=gen, device=dev).to(cdt)
            y, st = ssd.ssd_cuda(x, dt, A, B, C, chunk=chunk)
            wy, wst = ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            dy, ds = (y.float() - wy.float()).abs(), (st - wst).abs()
            errs[case] = max(float(dy.max()), float(ds.max()))
            ok = (bool((dy <= SSD_TOL[dtype] * (1 + wy.float().abs())).all())
                  and bool((ds <= SSD_TOL["float32"] * (1 + wst.abs())).all()))
            print(f"  K3 b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} {dtype}: "
                  f"max_abs_err y {float(dy.max()):.3e} state {float(ds.max()):.3e} "
                  f"tol {SSD_TOL[dtype]}/{SSD_TOL['float32']} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case == SSD_MODEL_CASES[0]:
                slice_args = x, dt, A, B, C
        k3["max_abs_err"] = errs[SSD_MODEL_CASES[0]]   # at the serving prefill shape
        chunk = SSD_SLICE["chunk"]
        k3["ms"] = cuda_ms(torch, lambda: ssd.ssd_cuda(*slice_args, chunk=chunk), 20)
        k3["plain_ms"] = cuda_ms(torch, lambda: ref.ssd_ref(*slice_args, chunk=chunk), 5)
        k3["bound_ms"], k3["bound_by"] = ssd_bound(*SSD_SLICE.values(), 2, PEAK_F32_FLOPS)
        print(f"  K3 at {SSD_SLICE} bf16: kernel {k3['ms']:.4f} ms, plain "
              f"{k3['plain_ms']:.4f} ms, library none, bound {k3['bound_ms']:.4f} ms "
              f"({k3['bound_by']})")
        if bad:
            raise AssertionError(f"K3 disagrees with ssd_ref in {bad}")

    def check_attention_bwd():
        gen = torch.Generator(dev).manual_seed(2)
        bad, errs = [], {}
        for case in SWEEP + BWD_CASES + D128_CASES:
            B, Sq, Skv, H, KV, D, dtype, causal, window = case
            dt = getattr(torch, dtype)
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt)
                           for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                                         (B, Sq, H, D)))
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                              window=window)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.attention_ref(*leaves, causal=causal, window=window or 0), leaves, do)
            torch.cuda.synchronize()
            err, ok = 0.0, True
            for g, w in zip(got, want):
                diff = (g.float() - w.float()).abs()
                err = max(err, float(diff.max()))
                ok &= bool((diff <= BWD_TOL[dtype] * (1 + w.float().abs())).all())
            errs[case] = err
            print(f"  K1 bwd B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} {dtype} "
                  f"causal={causal} window={window}: max_abs_err dq/dk/dv {err:.3e} "
                  f"tol {BWD_TOL[dtype]} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case == BWD_CASES[0]:
                train_args = q, k, v, o, lse, do
            del want, leaves
        k1b["max_abs_err"] = errs[BWD_CASES[0]]    # at the training shape
        q, k, v, o, lse, do = train_args
        # dq's atomics add in an order that changes from run to run: two runs
        # agree within the bf16 tolerance
        runs = [fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True) for _ in range(2)]
        torch.cuda.synchronize()
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*runs))
        agree = all(bool(((a.float() - b.float()).abs()
                          <= BWD_TOL["bfloat16"] * (1 + b.float().abs())).all())
                    for a, b in zip(*runs))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"  K1 bwd run twice at {TRAIN}: max |gap| {gap:.3e}, bitwise "
              f"{'equal' if same else 'different'}, tol {BWD_TOL['bfloat16']} "
              f"{'ok' if agree else 'MISMATCH'}")
        if not agree:
            bad.append("run twice")
        del runs
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*leaves, causal=True)
        k1b["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 3, warmup=1)
        del out
        # SDPA over the kv heads repeated to H (as the forward's yardstick);
        # only its backward is timed
        G = TRAIN["H"] // TRAIN["KV"]
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
                  for t in (k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        fns = [("kernel", lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)),
               ("sdpa backward", lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                             retain_graph=True))]
        if parent:
            fns.append(("earlier kernel", with_entry("_bwd_entry", parent["_bwd_entry"],
                                                     fns[0][1])))
        times = in_turns(torch, fns, 20)
        k1b["ms"] = sum(times["kernel"]) / 2
        k1b["library_ms"] = sum(times["sdpa backward"]) / 2
        if parent:
            k1b["earlier_ms"] = sum(times["earlier kernel"]) / 2
        k1b["bound_ms"], k1b["bound_by"] = attention_bwd_bound(
            *TRAIN.values(), 2, True, 0, PEAK_BF16_FLOPS)
        print(f"  K1 bwd at {TRAIN} bf16 causal, in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f"; plain {k1b['plain_ms']:.4f} ms, bound {k1b['bound_ms']:.4f} ms "
              f"({k1b['bound_by']})")
        if bad:
            raise AssertionError(f"K1 backward disagrees with autograd of attention_ref in {bad}")

    def check_quantize():
        cfg = get_config("llama3.2-1b")
        group = 256
        gen = torch.Generator(dev).manual_seed(3)
        cases = []
        for shape, g in QUANT_CASES:
            for dtype in ("float32", "bfloat16"):
                x = torch.randn(shape, generator=gen, device=dev) * 3
                flat = x.view(-1)
                flat[:g] = 0                                   # an all-zero group
                if flat.numel() >= 2 * g:                      # exact .5 ties: scale 1
                    tie = torch.arange(g, device=dev, dtype=torch.float32) % 7 - 3.5
                    tie[0] = 127
                    flat[g:2 * g] = tie
                cases.append((f"{shape}/{g} {dtype}", x.to(getattr(torch, dtype)), g))
        for name, shape in train_leaf_shapes(cfg).items():
            n = 1
            for d in shape:
                n *= d
            n += (-n) % group                                  # compress_tree pads to the group
            cases.append((f"leaf {name} {shape} -> ({n},)",
                          torch.randn((n,), generator=gen, device=dev) * 1e-3, group))
        bad = []
        for name, x, g in cases:
            q, s = quant.quantize_cuda(x, group=g)
            wq, ws = ref.quantize_ref(x, group=g)
            torch.cuda.synchronize()
            ok = torch.equal(q, wq) and torch.equal(s, ws)
            print(f"  K2 {name}: q and scales {'equal' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(name)
        k2["max_abs_err"] = 0.0 if not bad else None
        emb = next(x for name, x, _ in cases if "leaf embed" in name)
        k2["ms"] = cuda_ms(torch, lambda: quant.quantize_cuda(emb, group=group), 20)
        k2["plain_ms"] = cuda_ms(torch, lambda: ref.quantize_ref(emb, group=group), 5)
        k2["bound_ms"], k2["bound_by"] = quantize_bound(emb.numel(), group, 4)
        print(f"  K2 at the embedding leaf ({emb.numel()} f32 values, group {group}): kernel "
              f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, library none, bound "
              f"{k2['bound_ms']:.4f} ms ({k2['bound_by']})")
        if bad:
            raise AssertionError(f"K2 differs from quantize_ref in {bad}")

    phase("kernels K1", check_kernels)
    phase("kernels K1 backward", check_attention_bwd)
    phase("kernels K2", check_quantize)
    phase("kernels K3", check_ssd)

    # ---------------------------------------------------------------- serve
    def serve_full_width(arch):
        cfg = get_config(arch)
        B, P, T = 4, 2048, 32
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                          "--tokens", str(T), "--seed", "0"])
        counts = read_counts(f"serve {arch}")
        own = ARCHS[arch]
        kernels[own][0]["launches"] = counts[own]   # K1's is replaced by phase 5's
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  serve {arch}: prefill {res.prefill_s * 1e3:.2f} ms, decode "
              f"{B * T / res.decode_s:.1f} tokens/s ({res.decode_s / T * 1e3:.2f} ms/step), "
              f"peak memory {peak:.2f} GiB, launches {counts}")
        want = {key: cfg.n_layers if key == own else 0 for key in kernels}
        assert counts == want, f"{arch}: kernel launches {counts} in one request, want {want}"
        assert res.tokens.shape == (B, T) and bool(torch.isfinite(res.logits).all())
        assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab
        lines = [json.loads(x) for x in res.log.decode().splitlines()]
        assert lines == [{"batch": B, "prompt_len": P},
                         {"completed": B * T, "seconds": lines[1]["seconds"]}], lines
        print(f"  request log read back: {lines}")

    for arch in ARCHS:
        phase(f"serve {arch}", lambda: serve_full_width(arch))

    # --------------------------------------------------------------- decode
    def decode_matches_forward(arch):
        cfg = get_config(arch)
        S = 64
        full_f32 = None
        for dtype in ("float32", "bfloat16"):
            model = build(dataclasses.replace(cfg, compute_dtype=dtype))
            gen = torch.Generator(dev).manual_seed(1)
            with torch.inference_mode():
                params = model.init(gen)
                toks = torch.randint(1, cfg.vocab - 1, (1, S), generator=gen, device=dev,
                                     dtype=torch.int32)
                full, _ = model.forward(params, {"tokens": toks})
                if dtype == "float32" and arch in NOISE_HELD:
                    kernel_ssd, ops.ssd = ops.ssd, ref.ssd_ref
                    try:
                        plain_full, _ = model.forward(params, {"tokens": toks})
                    finally:
                        ops.ssd = kernel_ssd
                _, cache = model.prefill(params, {"tokens": toks[:, :1]}, S + 2)
                outs = []
                for t in range(1, S):
                    lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
                    outs.append(lg[:, 0])
                dec = torch.stack(outs, 1)
            assert bool(torch.isfinite(dec).all())
            diff = (dec - full[:, 1:S]).abs()
            gap, scale = float(diff.max()), float(full.abs().max())
            if dtype == "float32":
                full_f32 = full
            if dtype == "bfloat16" and arch in NOISE_HELD:
                noise = float((full - full_f32).abs().mean())
                print(f"  decode vs forward, {arch} {dtype}: mean |logit gap| "
                      f"{float(diff.mean()):.4e}, max {gap:.4e} (max |logit| {scale:.3f}), "
                      f"held to the bf16 forward's mean |gap| to f32 {noise:.4e}")
                assert float(diff.mean()) <= noise, f"{dtype}: decode/forward gap {diff.mean()}"
            else:
                plain = (f", with the plain scan {float((dec - plain_full[:, 1:S]).abs().max()):.4e}"
                         if dtype == "float32" and arch in NOISE_HELD else "")
                print(f"  decode vs forward, {arch} {dtype}: max |logit gap| {gap:.4e}{plain} "
                      f"(max |logit| {scale:.3f}), tol {DECODE_TOL[dtype]}")
                assert gap < DECODE_TOL[dtype], f"{dtype}: decode/forward gap {gap}"
            del params, cache

    for arch in ARCHS:
        phase(f"decode {arch}", lambda: decode_matches_forward(arch))

    # ---------------------------------------------------------------- train
    def train_full_width():
        cfg = get_config("llama3.2-1b")
        model, opt = build(cfg), AdamW(lr=TRAIN_LR)
        B, S = TRAIN["B"], TRAIN["Sq"]
        torch.cuda.reset_peak_memory_stats()
        state = tsteps.init_train_state(model, opt, torch.Generator(dev).manual_seed(0))
        shapes = {key: tuple(t.shape) for key, t in flatten(state["params"])}
        assert shapes == train_leaf_shapes(cfg), shapes
        step_fn = tsteps.make_train_step(model, opt, compress=True)
        pipe = SyntheticTokens(cfg.vocab, B, S, seed=0)
        # per step: K1 once per layer in the forward and once more when the
        # "dots" remat recomputes the layer for the backward; its backward
        # once per layer; K2 once per gradient leaf
        want = {"k1": 2 * cfg.n_layers, "k1b": cfg.n_layers, "k2": len(shapes), "k3": 0}
        print(f"  remat {cfg.remat!r}, compute {cfg.compute_dtype}, params {cfg.param_dtype}, "
              f"launches wanted per step {want}")
        losses, times = [], []
        zero_counts()
        for i in range(TRAIN_STEPS):
            batch = {"tokens": torch.from_numpy(pipe.next()["tokens"]).to(dev)}
            before = {key: fn.launches for key, (_, fn) in kernels.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step = {key: fn.launches - before[key] for key, (_, fn) in kernels.items()}
            losses.append(loss)
            print(f"  step {i + 1}: loss {loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, "
                  f"{times[-1] * 1e3:.2f} ms, {B * S / times[-1]:.1f} tokens/s, "
                  f"launches {per_step}")
            assert per_step == want, f"step {i + 1}: launches {per_step}, want {want}"
        counts = read_counts("train llama3.2-1b")
        for key in ("k1", "k1b", "k2"):
            kernels[key][0]["launches"] = counts[key]
        warm = times[1:]
        print(f"  train llama3.2-1b B={B} S={S}: warm step {sum(warm) / len(warm) * 1e3:.2f} ms "
              f"({B * S * len(warm) / sum(warm):.1f} tokens/s), first step "
              f"{times[0] * 1e3:.2f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts}")
        assert all(math.isfinite(x) for x in losses), losses
        assert losses[-1] < losses[0], f"loss did not fall: {losses}"
        del state

    def train_loop_smoke():
        cfg = get_smoke("llama3.2-1b")
        steps = 12
        zero_counts()
        out = launch_train.main(["--smoke", "--steps", str(steps), "--ckpt-every", "5",
                                 "--compress-grads"])
        counts = read_counts("train loop llama3.2-1b SMOKE")
        want = {"k1": steps * 2 * cfg.n_layers, "k1b": steps * cfg.n_layers,
                "k2": steps * len(train_leaf_shapes(cfg)), "k3": 0}
        print(f"  launch.train --smoke: {steps} steps, loss {out['first_loss']:.4f} -> "
              f"{out['last_loss']:.4f}, launches {counts}")
        assert counts == want, f"launches {counts}, want {want}"
        assert out["steps"] == steps and math.isfinite(out["last_loss"])
        # the port of tests/test_system.py::test_crash_restart_resumes_exactly
        pol = Policy(entry_size=16384, log_entries=8192, page_size=4096, read_cache_pages=64,
                     batch_min=8, batch_max=512, verify_crc=False)
        tier = Tier(DRAM)
        nv = NVCache(pol, tier, track_crashes=True)
        model, opt = build(cfg), AdamW(lr=1e-3)
        pipe = SyntheticTokens(cfg.vocab, batch=2, seq=32, seed=9)
        _, hist1 = train_loop.train(model, opt, pipe, NVCacheFS(nv), total_steps=17,
                                    ckpt_every=10)
        recover(nv.crash(), pol, tier.open)   # the step-17 checkpoint may be only in the log
        nv2 = NVCache(pol, tier)
        pipe2 = SyntheticTokens(cfg.vocab, batch=2, seq=32, seed=9)
        try:
            state2, hist2 = train_loop.train(model, opt, pipe2, NVCacheFS(nv2), total_steps=20,
                                             ckpt_every=10)
        finally:
            nv2.shutdown()
        print(f"  crash after {len(hist1)} steps, recovered, resumed: {len(hist2)} more steps, "
              f"pipeline at step {pipe2.step}, optimizer step {int(state2['opt']['step'])}, "
              f"device {state2['params']['embed'].device}")
        assert len(hist1) == 17 and len(hist2) == 3 and pipe2.step == 20
        assert int(state2["opt"]["step"]) == 20 and state2["params"]["embed"].is_cuda

    phase("train llama3.2-1b", train_full_width)
    phase("train loop SMOKE", train_loop_smoke)

    print(json.dumps({"kernels": [k1, k1b, k2, k3]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
