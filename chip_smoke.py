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
             phases drive it at and, for K1, at bf16 head dim 128 and at
             MLA's q/k head dim 96 with v head dim 64 (SMOKE: 24 and 16),
             and at hymba-1.5b's shapes (K1 at 25 query heads on 5 kv heads
             with window 1024 and without, forward and backward; K3 at state
             16 over 50 heads, reading the views of one 3232-wide row), and
             K1 at head dim 128 at minitron-8b's, granite-20b's (MQA),
             qwen2-vl-7b's and qwen3-moe-30b-a3b's groups of 4, 48, 7 and 8
             query heads per kv head, and the K1 backward at granite-20b's
             full shape (from 8 query heads a kv head on: fp32 row sums,
             then P and dS as two bf16 terms), and at the MoE SMOKE steps'
             shapes, with its time at its main path's shape beside the plain version's, a
             library call's (where one PyTorch call computes the same) and
             the card's bound; two K1 backward runs must agree (dq adds with
             atomics); each K1 and K3 case names the route it must take and
             is checked to have taken it; K1's times and the library's
             (at llama's, minicpm3's, hymba's, minitron's, granite's,
             qwen2-vl's and qwen3-moe's prefill, SDPA given hymba's window
             as a boolean mask), the backward's (at llama's, minicpm3's and
             granite's), and K3's and its plain version's (at
             mamba2's and hymba's), are taken in turns; K1 at whisper-small's
             shapes, forward and backward: non-causal over its 1500 encoder
             frames, and in cross-attention from 8 and 188 decoder tokens to
             them (a ragged last key tile, one q tile), the forward timed at
             the encoder's shape beside SDPA; with those of an earlier
             commit's K1 and K3 sources when they are copied into
             build/parent/ (an older K1, whose C interface has no Dv, is
             timed at llama's shape only); K1 at llama3.2-1b's
             prefill_32k shape (batch 16, S 32768) on sampled query rows
             against the plain version over the keys they see, each block
             also by its relative error norm, timed beside SDPA; K1 forward
             and backward at phase 6's train_4k cut (4 x 4096) and 100m
             example (8 x 512, 12 heads on 4); K3 at mamba2-780m's
             prefill_32k (b 1, s 32768, timed) and at phase 6's cut of it
             (b 16, x, B and C views of one 3328-wide row), every batch row
             against the plain version; K3's backward (dx, ddt, dA, dB, dC)
             against autograd of the plain version at mamba2-780m's and
             hymba-1.5b's train shapes on the projection views, at phase
             6's train_4k rows (all four on the wgmma route), and at the
             SMOKE and sweep shapes in both dtypes (fma route), dx
             bit-equal over two runs, and both routes timed in turns at
             the two train shapes beside the plain version;
  3. serve   llama3.2-1b, mamba2-780m, minicpm3-4b, hymba-1.5b (K1 and K3
             in every layer), minitron-8b, granite-20b (learned positions,
             bfloat16 parameters: its float32 ones do not fit the card),
             qwen2-vl-7b (M-RoPE), qwen3-moe-30b-a3b (128 experts, top
             8, bfloat16 parameters; the (token, k) pairs a prefill drops
             over capacity printed) and whisper-small (the encoder-decoder:
             prompt 1500 zero frames, a decoder prompt of 8 tokens; K1 in
             its 12 encoder layers and twice in each of its 12 decoder
             layers) at full width (batch 4, prompt 2048, 32
             new tokens) through ``repro_torch.launch.serve.main``, with the
             kernels' launch counts (and K1's and K3's routes) set to 0 just
             before and read just after each run, the decode replayed as one
             captured CUDA graph a step outside the MoE and encoder-decoder
             families (the decode time printed includes the capture), and
             the request log read back through the port's NVCacheFS;
  4. decode  teacher-forced decode against the full-sequence forward at full
             width, for each model, in float32 and in bfloat16 (MLA: the
             absorbed latent decode against the expanded forward; hymba
             also from a 1040-token prefill, past its window of 1024;
             qwen2-vl also from a prefill of text and an image grid whose
             three M-RoPE position streams differ; qwen3-moe, and arctic-480b
             at SMOKE size, at a capacity that drops nothing; whisper-small
             over 1500 random frames);
  5. train   llama3.2-1b, mamba2-780m (K3 and its backward in every layer)
             and hymba-1.5b (K1, K3 and both backwards) at full width (batch
             4 x 2048, bf16 compute, f32 parameters, AdamW, int8-compressed
             gradients) for a few steps through
             ``init_train_state``/``make_train_step``, with exact launch
             counts per step and a falling loss; mamba2-780m and hymba-1.5b
             at SMOKE size as minicpm3-4b below; minicpm3-4b at SMOKE
             size: its loss and gradients on the card against the CPU route
             from the same parameters, then one step and the launcher's
             loop with exact launch counts; granite-20b at SMOKE size
             (learned positions, MQA), qwen3-moe-30b-a3b and arctic-480b
             (MoE, the aux loss in the loss, routes on the card held to the
             CPU route's first) and whisper-small (frames and decoder
             tokens) the same way; then the training loop at
             SMOKE size through
             ``repro_torch.launch.train.main``, and a crash, NVMM-log
             recovery and resume that lands on the exact step;
  6. shapes  the JAX package's assigned cells (``configs/shapes.py``)
             through the port's step builders (``launch/dryrun.py``'s
             card run): llama3.2-1b prefill_32k, decode_32k and train_4k,
             mamba2-780m prefill_32k, decode_32k, long_500k and train_4k,
             hymba-1.5b long_500k and train_4k, each at the largest
             power-of-two batch that does
             not run out of memory, with exact launches a step and every
             K1 and K3 launch on its wgmma route; then
             ``examples/torch_train_e2e.py --preset 100m`` (20 steps,
             checkpoints through NVCache) and ``launch/ckpt_bench.py`` at
             64 MiB a leaf from a CUDA state, each restore held exactly;
  7. mesh    the distribution layer (``launch/mesh_check.py``): on the 1x1
             mesh (NCCL), phase 5's llama3.2-1b train step through
             ``train_shardings`` against the unsharded step on the same
             state and batch (loss, parameters, each leaf's gradient
             beside the unsharded step's own run-to-run gap, equal
             launches; the two timed in turns: DTensor's host cost), a
             prefill of 4 x 2048 and 8 decode steps through
             ``serve_shardings``, and mamba2-780m served the same way (K3
             on the rank's heads); then phase 5's mamba2-780m train step
             the same way (K3 and its backward on the rank's heads through
             ``ops.ssd``; loss, parameters and each leaf's gradient beside
             the unsharded run-to-run gap, launches K3 96, K3 backward 48
             on wgmma, K2 11, the peak memory and DTensor's host cost);
             then four gloo ranks on the one card: ``compressed_psum`` and
             the GPipe schedule, each held to one rank's result.  The mesh
             path's launches are counted from 0 around each sharded run
             only;
  8. tooling the dry run's mesh mode (``launch/dryrun.py --mesh``: fake
             worlds of 256 and 512 ranks, meta tensors) for llama3.2-1b
             train_4k on 16x16 and 2x16x16, qwen3-moe-30b-a3b train_4k,
             mamba2-780m prefill_32k and whisper-small decode_32k on 16x16,
             each with its per-device bytes, counts and collectives; the
             roofline (``launch/roofline.py``) of phase 6's cells at their
             full batch and their cut, each cut's bound at or below its
             fastest measured step; and ``launch/perf_probe.py`` once.  It
             launches no kernel.
  9. engine  the NVCache engine's own paths on the card's host, each in a
             process of its own: the paper's figure benchmarks
             (``launch/engine_bench/run_all.py`` at its default scale, into
             ``build/engine_bench.json``), then together the crash demo
             (``examples/torch_crash_recovery_demo.py``) for seeds 0-2, the
             flight dump's ``--selftest`` and the lint of the port's
             ``core`` and ``obs``.  Every acknowledged key reads back, the
             lint finds nothing, the selftest passes, no figure scans the
             whole log and the figures' counts are finite and non-zero;
             their ratios (legacy speedups over sync SSD, the rebalance,
             the read-op reduction, the dual mode's byte reduction) are
             printed, not held.  Host code: it launches no kernel.
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when there is no CUDA card or a phase fails.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the kernels each arch's prefill launches, once per layer each (K1:
# ``k1_calls``, three a whisper-small encoder and decoder layer pair)
ARCHS = {"llama3.2-1b": ("k1",), "mamba2-780m": ("k3",), "minicpm3-4b": ("k1",),
         "hymba-1.5b": ("k1", "k3"), "minitron-8b": ("k1",), "granite-20b": ("k1",),
         "qwen2-vl-7b": ("k1",), "qwen3-moe-30b-a3b": ("k1",), "whisper-small": ("k1",)}
# K1 cases: (B, Sq, Skv, H, KV, D, Dv, dtype, causal, window), D of q/k, Dv of v
SLICE = dict(B=4, Sq=2048, Skv=2048, H=32, KV=8, D=64, Dv=64)   # llama3.2-1b prefill, batch 4
MASKS = [(True, None), (False, None), (True, 24)]
SWEEP = [(B, Sq, Skv, H, KV, D, D, dtype, causal, window)
         for B, Sq, Skv, H, KV, D in [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
                                      (1, 48, 96, 4, 1, 64)]
         for dtype in ("float32", "bfloat16")
         for causal, window in MASKS]
# the shapes the phases below drive K1 at: serve's prefill, then the decode
# phase's forward over 64 tokens and its prefill of one token, in both dtypes
MODEL_CASES = [(*SLICE.values(), "bfloat16", True, None)] + [
    (1, S, S, 32, 8, 64, 64, dtype, True, None)
    for S in (64, 1) for dtype in ("float32", "bfloat16")]
# phase 6's train shapes, forward and backward: llama3.2-1b's train_4k at its
# batch cut (4 of 256) and examples/torch_train_e2e.py's 100m preset (batch
# 8, seq 512, 12 heads on 4 kv heads of 64)
SHAPE_K1_CASES = [(4, 4096, 4096, 32, 8, 64, 64, "bfloat16", True, None),
                  (8, 512, 512, 12, 4, 64, 64, "bfloat16", True, None)]
MODEL_CASES += SHAPE_K1_CASES
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the bf16 wgmma kernels' other head dim, forward and backward: several full
# 128-row tiles, and a window
D128_CASES = [(2, 2048, 2048, 16, 4, 128, 128, "bfloat16", True, None),
              (2, 200, 200, 8, 2, 128, 128, "bfloat16", True, 24)]
# MLA (minicpm3-4b): q/k head dim 96 (nope 64 + rope 32) with v head dim 64,
# all 40 heads their own kv head.  Serve's prefill, the decode phase's
# forward over 64 tokens and its one-token prefill in both dtypes, then
# SMOKE's 24 / 16 in both dtypes and every mask, MQA with Skv != Sq among them
MLA = dict(B=4, Sq=2048, Skv=2048, H=40, KV=40, D=96, Dv=64)   # minicpm3-4b prefill, batch 4
MLA_CASES = [(*MLA.values(), "bfloat16", True, None)] + [
    (1, S, S, 40, 40, 96, 64, dtype, True, None)
    for S in (64, 1) for dtype in ("float32", "bfloat16")] + [
    (B, Sq, Skv, H, KV, 24, 16, dtype, causal, window)
    for B, Sq, Skv, H, KV in [(2, 64, 64, 4, 4), (1, 48, 96, 4, 1)]
    for dtype in ("float32", "bfloat16")
    for causal, window in MASKS]
# hymba-1.5b (hybrid): 25 query heads on 5 kv heads (G = 5) at head dim 64,
# window 1024 in 29 of its 32 layers and full causal attention in 3.
# Serve's prefill, then the decode phase's forwards over 64 and 1088 tokens
# and its prefills of 1 and 1040 tokens, each in both dtypes and both masks
HYMBA = dict(B=4, Sq=2048, Skv=2048, H=25, KV=5, D=64, Dv=64)   # hymba-1.5b prefill, batch 4
HYMBA_WINDOW = 1024
HYMBA_CASES = [(*HYMBA.values(), dtype, True, window)
               for dtype in ("bfloat16", "float32") for window in (HYMBA_WINDOW, None)] + [
    (1, S, S, 25, 5, 64, 64, dtype, True, window)
    for S in (64, 1, 1088, 1040) for dtype in ("float32", "bfloat16")
    for window in (HYMBA_WINDOW, None)]
# minitron-8b, granite-20b, qwen2-vl-7b and qwen3-moe-30b-a3b: head dim 128
# with (H, KV) of (32, 8), (48, 1), (28, 4) and (32, 4), groups of 4, 48
# (MQA), 7 and 8.  Serve's prefills, then the decode phase's forwards over
# 64 tokens and its one-token prefills in both dtypes, and qwen2-vl's
# image-grid run: a 264-token prefill and the forward over 296 tokens
D128_SERVE = {"minitron-8b": (32, 8), "granite-20b": (48, 1), "qwen2-vl-7b": (28, 4),
              "qwen3-moe-30b-a3b": (32, 4)}
D128_SERVE_CASES = [(4, 2048, 2048, H, KV, 128, 128, "bfloat16", True, None)
                    for H, KV in D128_SERVE.values()] + [
    (1, S, S, H, KV, 128, 128, dtype, True, None)
    for H, KV in D128_SERVE.values() for S in (64, 1) for dtype in ("float32", "bfloat16")] + [
    (1, S, S, 28, 4, 128, 128, dtype, True, None)
    for S in (264, 296) for dtype in ("float32", "bfloat16")]
# phase 5's granite-20b SMOKE step (batch 2, seq 32, 4 heads on one kv head
# of 16) in both dtypes, and its launcher's loop (seq 64), forward and backward
GRANITE_SMOKE_CASES = [(2, S, S, 4, 1, 16, 16, dtype, True, None)
                       for S, dtype in ((32, "float32"), (32, "bfloat16"), (64, "bfloat16"))]
# the MoE SMOKE models (4 heads on 2 kv heads; qwen3-moe of 32, arctic of 16):
# phase 5's steps in both dtypes and the launcher's loop (seq 64), forward
# and backward, and phase 4's arctic decode (64 tokens, one-token prefill)
MOE_SMOKE_CASES = [(B, S, S, 4, 2, D, D, dtype, True, None)
                   for D in (32, 16)
                   for B, S, dtype in ((2, 32, "float32"), (2, 32, "bfloat16"),
                                       (2, 64, "bfloat16"))] + [
    (1, S, S, 4, 2, 16, 16, dtype, True, None) for S in (64, 1) for dtype in ("float32", "bfloat16")]
# whisper-small (the encoder-decoder): 12 heads of 64, each its own kv head.
# Serve's prefill (batch 4): the encoder non-causal over its 1500 frames, the
# decoder's self-attention causal over its 8-token prompt, and cross-attention
# non-causal from those 8 queries (one q tile) to the 1500 frames (a ragged
# last key tile: 1500 = 11·128 + 92 = 23·64 + 28); then the decode phase's
# encoder, its forward over 64 decoder tokens and its one-token prefill, in
# both dtypes
WHISPER = dict(B=4, Sq=1500, Skv=1500, H=12, KV=12, D=64, Dv=64)   # the encoder, batch 4
WHISPER_CASES = [(*WHISPER.values(), "bfloat16", False, None),
                 (4, 8, 8, 12, 12, 64, 64, "bfloat16", True, None),
                 (4, 8, 1500, 12, 12, 64, 64, "bfloat16", False, None)] + [
    (1, Sq, Skv, 12, 12, 64, 64, dtype, causal, None)
    for Sq, Skv, causal in ((1500, 1500, False), (64, 64, True), (1, 1, True),
                            (64, 1500, False), (1, 1500, False))
    for dtype in ("float32", "bfloat16")]
# phase 5's whisper-small SMOKE step (batch 2: 32 frames, 4 decoder tokens;
# 4 heads of 16) in both dtypes, and its launcher's loop (64 frames, 8
# tokens), forward and backward: encoder, decoder self and cross
WHISPER_SMOKE_CASES = [(2, Sq, Skv, 4, 4, 16, 16, dtype, causal, None)
                       for enc, dtype in ((32, "float32"), (32, "bfloat16"), (64, "bfloat16"))
                       for Sq, Skv, causal in ((enc, enc, False), (enc // 8, enc // 8, True),
                                               (enc // 8, enc, False))]
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
TRAIN = dict(B=4, Sq=2048, Skv=2048, H=32, KV=8, D=64, Dv=64)
BWD_CASES = [(*TRAIN.values(), "bfloat16", True, None),
             (2, 64, 64, 4, 2, 16, 16, "bfloat16", True, None),
             (2, 32, 32, 4, 2, 16, 16, "bfloat16", True, None)] + SHAPE_K1_CASES
# the backward at minicpm3's full shape (timed, and run twice), and at the
# SMOKE step of phase 5 (batch 2, seq 32, 4 heads of 24 / 16)
MLA_BWD_CASES = [(*MLA.values(), "bfloat16", True, None),
                 (2, 32, 32, 4, 4, 24, 16, "bfloat16", True, None)]
# and at hymba's prefill shape with its window, the shape phase 5's full-width
# hymba-1.5b step runs it at (dk and dv sum over G = 5)
HYMBA_BWD_CASES = [(*HYMBA.values(), "bfloat16", True, HYMBA_WINDOW)]
# and at whisper-small's encoder (non-causal, Skv = Sq = 1500) and at the
# cross-attention of a training batch of 1500 frames (``SyntheticTokens``'
# encdec draw has 1500 // 8 = 187 decoder tokens; 188 rounds up): what a
# full-width whisper-small step would run on the wgmma route; off every main
# path (whisper trains at SMOKE size, on the mma route)
WHISPER_BWD_CASES = [(*WHISPER.values(), "bfloat16", False, None)] + [
    (4, Sq, 1500, 12, 12, 64, 64, "bfloat16", False, None) for Sq in (187, 188)]
# and at granite-20b's prefill shape: MQA, 48 query heads' dk and dv summed
# into one kv head, so the wgmma backward first takes the row sums in fp32
# and then feeds P and dS as two bf16 terms (TWO_TERM_GROUP in its source);
# timed, off every main path (granite trains at SMOKE size)
GRANITE = dict(B=4, Sq=2048, Skv=2048, H=48, KV=1, D=128, Dv=128)
GRANITE_BWD_CASES = [(*GRANITE.values(), "bfloat16", True, None)]
# phase 5's minicpm3, granite and MoE SMOKE steps on the card against the
# CPU route, same parameters and tokens: float32 sums in another order (the
# card's float32 products in full fp32); bfloat16 rounds P and dS in the
# kernels and the activations at other places, as the CPU tests' bf16
# bounds against JAX:
# loss |d| <= tol, gradients |d| <= tol·(1+|ref|)
STEP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-3, 1e-2)}   # (loss, gradients)
# mamba2-780m's and hymba-1.5b's SMOKE gradients in bfloat16: 3e-2·(1+|ref|),
# the CPU tests' bound for these two families against JAX
# (tests/test_torch_train.py::test_loss_and_grads_match_jax: their gated norm,
# conv and scan each round, 1.44e-2 and 1.12e-2 measured there); on the card
# the K3 backward also sums each group's dB and dC in fp32 where the CPU
# route's autograd rounds every head's first (``ref.ssd_bwd_ref``).  Their
# loss and float32 bounds are STEP_TOL's
SSM_GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# An MoE step's routes on the card are held to the CPU route's first: the
# same ordered experts wherever the CPU's router probabilities among a
# token's k + 1 largest lie further apart than twice the largest |dp|
# between the two sides' (only rounding can flip or reorder a token's
# experts there; those few take the CPU's experts, as
# tests/test_torch_moe.py::routes_as_jax does against JAX), and |dp| at
# most ROUTER_DP (the CPU tests' bounds against JAX)
ROUTER_DP = {"float32": 1e-5, "bfloat16": 1e-2}
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
# K3: mamba2-780m prefill, batch 4 (b, s, h, p, g, n, chunk); its bf16
# route is bound at the bf16 tensor-core peak, the f32 route at the fp32 one
SSD_SLICE = dict(b=4, s=2048, h=48, p=64, g=1, n=128, chunk=256)
SSD_SWEEP = [(*shape, dtype)
             for shape in [(1, 32, 2, 8, 1, 8, 8), (2, 64, 4, 16, 2, 16, 16),
                           (1, 128, 4, 32, 1, 32, 32)]
             for dtype in ("float32", "bfloat16")]
# the shapes the phases below drive K3 at: serve's prefill, then the decode
# phase's forward over 64 tokens and its prefill of one token, which
# ssm_forward pads to the same 64 rows (chunk 64); and chunk 1, the fma
# route's least
SSD_MODEL_CASES = [(*SSD_SLICE.values(), "bfloat16")] + [
    (1, S, 48, 64, 1, 128, S, dtype) for S in (64, 1) for dtype in ("float32", "bfloat16")]
# hymba-1.5b: state 16 over 50 heads.  Serve's prefill, with x, B and C the
# views of one 3232-wide row that ssm_forward hands over; then the decode
# phase's forward over 64 tokens (its one-token prefill pads to the same 64
# rows) and over 1088 tokens (its 1040-token prefill pads to the same 1280
# rows), in both dtypes
HYMBA_SSD = dict(b=4, s=2048, h=50, p=64, g=1, n=16, chunk=256)
HYMBA_SSD_CASES = [(*HYMBA_SSD.values(), "bfloat16")] + [
    (1, S, 50, 64, 1, 16, chunk, dtype) for S, chunk in ((64, 64), (1280, 256))
    for dtype in ("float32", "bfloat16")]
SSD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # y; the float32 state is held to 2e-3
# The JAX package's assigned long shapes (configs/shapes.py): K1 at
# llama3.2-1b's prefill_32k, the batch cut as phase 6 runs it (the full 32
# does not fit the card), checked on the sampled query rows ROWS_32K (the
# first 256, a block in the middle and the last 256, each over the keys it
# sees: the whole score matrix would take over 1 TB) and timed beside SDPA.
# Each sampled block is also held to ||got - ref|| <= REL_32K ||ref||: late
# rows average ~16k values and are ~0.01 in size, where the per-element
# bound alone would pass an error twice their size.
# K3 at mamba2-780m's prefill_32k shape, batch 1, 128 chunks of 256 (timed);
# and at phase 6's batch cut, 16, with x, B and C the views of one 3328-wide
# row as ssm_forward hands them over (a span of 1.7e9 elements)
LLAMA_32K = dict(B=16, Sq=32768, Skv=32768, H=32, KV=8, D=64, Dv=64)
ROWS_32K = ((0, 256), (16384, 16640), (32768 - 256, 32768))
REL_32K = 1e-2
SSD_32K = dict(b=1, s=32768, h=48, p=64, g=1, n=128, chunk=256)
SSD_32K_CASE = (*SSD_32K.values(), "bfloat16")
SSD_32K_CUT_CASE = (16, *SSD_32K_CASE[1:])
# K3's backward (dx, ddt, dA, dB, dC against ssd_bwd_ref, the gradient in
# float32 cast once): the full-width train steps' shapes (4 x 2048, x, B and C
# the views of one 3328- or 3232-wide row; timed), a train_4k row (s 4096,
# chunk 256), and the SMOKE steps' (batch 2, seq 32 and the launcher's 64:
# mamba2 8 heads of 16 at state 16, hymba state 8, chunk 16) and the sweep's
# shapes in both dtypes, one with d(final state).  dx, ddt, dB, dC by
# SSD_TOL·(1+|ref|); dA, a sum over every (batch, step), by ||d||/||ref||.
# Each case takes the route ssd_route_wanted names (dy contiguous): wgmma
# for the four bf16 rows at p 64, fma for the SMOKE (p 16) and f32 ones
SSD_BWD_CASES = [(*SSD_SLICE.values(), "bfloat16", "views", False),
                 (*HYMBA_SSD.values(), "bfloat16", "views", False),
                 (1, 4096, 48, 64, 1, 128, 256, "bfloat16", "views", False),
                 (1, 4096, 50, 64, 1, 16, 256, "bfloat16", "views", False)] + [
    (2, S, 8, 16, 1, n, 16, dtype, "contiguous", False)
    for S in (32, 64) for n in (16, 8) for dtype in ("float32", "bfloat16")] + [
    (*case[:7], case[7], "contiguous", i == 3) for i, case in enumerate(SSD_SWEEP)]
SSD_BWD_DA_REL = {"float32": 1e-3, "bfloat16": 1e-2}
# Phase 5's full-width train steps: the arch and the kernels its step runs
TRAIN_ARCHS = {"llama3.2-1b": ("k1",), "mamba2-780m": ("k3",), "hymba-1.5b": ("k1", "k3")}
# Phase 6: (arch, shape, steps) of the cells run on the card through
# configs/shapes.py and train/steps.py (launch/dryrun.py's card run), each at
# the largest power-of-two batch from the shape's own down that runs
SHAPE_CELLS = [("llama3.2-1b", "prefill_32k", 2), ("llama3.2-1b", "decode_32k", 4),
               ("llama3.2-1b", "train_4k", 2), ("mamba2-780m", "prefill_32k", 2),
               ("mamba2-780m", "decode_32k", 4), ("mamba2-780m", "long_500k", 4),
               ("hymba-1.5b", "long_500k", 4), ("mamba2-780m", "train_4k", 2),
               ("hymba-1.5b", "train_4k", 2)]
# Phase 8: the dry run's mesh mode (launch/dryrun.py) on this host's torch:
# a dense train step on both production meshes, expert parallelism's
# all-to-alls, K3 as a unit on each rank's heads, and the encoder-decoder's
# cache on a mesh
TOOLING_MESH_CELLS = {"single": [("llama3.2-1b", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k"),
                                 ("mamba2-780m", "prefill_32k"), ("whisper-small", "decode_32k")],
                      "multi": [("llama3.2-1b", "train_4k")]}
TOOLING_KEYS = ("devices", "counted_s", "state_bytes", "input_bytes", "cache_bytes",
                "output_bytes", "resident_bytes", "fits_one_card", "flops", "flops_by_dtype",
                "work_flops", "work_hbm_bytes", "hbm_bytes", "collectives", "wire_bytes", "groups")
E2E_STEPS, E2E_CKPT_EVERY = 20, 10   # examples/torch_train_e2e.py --preset 100m
CKPT_MIB = 64                        # repro_torch.launch.ckpt_bench from a CUDA state
# Phase 9: the crash demo's seeds, and the figures' counts that must be
# non-zero (a path into run_all's JSON)
ENGINE_DEMO_SEEDS = (0, 1, 2)
ENGINE_COUNTS = (("cold_read", "read_ops_per_byte"), ("cold_read", "read_ops_per_byte_readahead1"),
                 ("trickle", "page_writes_per_committed_byte"),
                 ("coalesce", "page_writes_per_committed_byte"),
                 ("dualmode", "persisted_bytes_per_committed_byte_log"),
                 ("dualmode", "persisted_bytes_per_committed_byte_paged"),
                 ("dirty_miss", "dirty_misses"), ("dirty_miss", "pages"),
                 ("fsync_epoch_hot_file", "fsyncs_issued"),
                 ("legacy", "sqlite_rollback_journal", "meta_ops", "create"),
                 ("legacy", "sqlite_wal", "meta_ops", "ftruncate"),
                 ("legacy", "rocksdb_style", "meta_ops", "create"))
ENGINE_TIMEOUT = 300                 # seconds a process of phase 9 may take


def ssd_route_wanted(p, n, chunk, dtype):
    """The route each K3 case must take: the wgmma kernels for bf16 at head
    dim 64, n a multiple of 16 and a chunk a multiple of 64 (contiguous
    inputs), the fma kernel otherwise."""
    return "wgmma" if dtype == "bfloat16" and p == 64 and n % 16 == 0 and chunk % 64 == 0 else "fma"


# max |logit| gap, 64 tokens: float32 sums in another order; bfloat16
# re-rounding of the residual stream over the layers.  minicpm3-4b (62
# layers) is held to the same rule: its absorbed decode reorders the bf16
# products, and on the CPU at SMOKE widths and full depth its bf16 max gap
# is 0.117 with the mean gap at its bf16 noise (so the noise rule below does
# not fit it), its float32 gap 4.4e-6
# (tests/test_torch_mla.py::test_mla_decode_gap_at_full_depth)
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
# recurrence.  hymba-1.5b's SSM half makes its gap grow with depth too, in
# JAX as in the port (tests/test_torch_lm.py::
# test_hymba_decode_gap_tracks_jax_with_depth), and at its 32 layers the
# mean gap sits at the noise itself, 0.90-0.94x of it in JAX and 0.89-1.09x
# in the port over three draws at SMOKE widths (tests/test_torch_hybrid.py::
# test_decode_gap_sits_at_the_bf16_noise_in_jax_too), so the noise alone
# leaves it no margin.  It is held to twice the noise: the bf16 decode and
# the bf16 forward each lie about the noise from the f32 forward, so they
# lie at most twice that from each other.  minitron-8b, granite-20b and
# qwen2-vl-7b are held to twice the noise too.  At SMOKE widths and full
# depth (32, 52 and 28 layers) on the CPU their bf16 mean gap is 0, 0.81x
# and 0.47x the noise, their max gap 0 to 0.086
# (tests/test_torch_positions.py::test_bf16_decode_gap_at_full_depth); but
# there decode and forward run the same plain attention.  On the card the
# forward's is K1, P rounded to bf16, and decode's is plain torch, so the two
# round apart as bf16 and f32 do, and the noise, taken on the card from the
# same weights, scales their gap at any width and depth, where a fixed max
# such as llama's 0.25 would be a guess at granite's 52 layers of 6144.
# Factor per arch:
NOISE_HELD = {"mamba2-780m": 1, "hymba-1.5b": 2, "minitron-8b": 2, "granite-20b": 2,
              "qwen2-vl-7b": 2, "qwen3-moe-30b-a3b": 2, "arctic-480b": 2,
              "whisper-small": 2}
# whisper-small is held to twice the noise too: at SMOKE widths and its 12 +
# 12 layers on the CPU its bf16 mean gap is 0-4e-6x the noise in JAX and
# 0-0.20x in the port over three draws, and at 2 + 2 layers under the noise
# as well (tests/test_torch_encdec.py::test_bf16_decode_gap_at_full_depth_tracks_jax):
# no drift with depth, and on the card its forward's three attentions run K1
# (P in bf16) where decode's run plain torch, as the dense models'.
# qwen3-moe-30b-a3b and arctic-480b SMOKE are held to twice the noise too:
# at SMOKE widths and qwen3-moe's 48 layers on the CPU, with a capacity that
# drops nothing, the bf16 mean gap is 0.003-0.24x the noise in JAX and 0-0.23x
# in the port over three token draws, a routing flip at a near tie making
# all of it (tests/test_torch_lm.py::
# test_qwen3_moe_decode_gap_at_full_depth_tracks_jax): routing adds no drift
# with depth.  Their decode checks run at capacity factor E / k (C >= the
# group), where the forward drops no (token, k) pair: a decode step never
# drops one, and at 1.25 the forward does, so the two differ at those tokens
# in JAX as in the port (tests/test_torch_moe.py::
# test_decode_differs_from_forward_at_dropped_pairs_in_jax_too).
# (prompt, tokens, image grid) of each teacher-forced decode check: a
# one-token prefill and 63 steps (whisper-small's decoder tokens, over
# WHISPER_FRAMES random frames); for hymba-1.5b also a 1040-token prefill
# and 48 steps, each of which sees only the last 1024 keys in its windowed
# layers; for qwen2-vl-7b also a prefill of 8 text tokens and a 16 x 16 image
# (image_grid_positions) and 32 steps
DECODE_RUNS = {"hymba-1.5b": ((1, 64, None), (1040, 1088, None)),
               "qwen2-vl-7b": ((1, 64, None), (264, 296, (8, 16)))}
WHISPER_FRAMES = 1500


def train_launches(cfg, kernels):
    """Launches of one training step under remat "dots" (or "none") of a
    model whose layers run ``kernels`` ("k1", "k3"): each kernel once a
    layer in the forward and once more where remat recomputes the layer,
    its backward once a call (``k1_train_calls``, ``k1_calls``); K2 0."""
    per = {"k1": 0, "k1b": 0, "k2": 0, "k3": 0, "k3b": 0}
    if "k1" in kernels:
        per["k1"], per["k1b"] = k1_train_calls(cfg), k1_calls(cfg)
    if "k3" in kernels:
        per["k3"] = cfg.n_layers * (1 if cfg.remat == "none" else 2)
        per["k3b"] = cfg.n_layers
    return per


def k1_calls(cfg):
    """K1 launches of one full-sequence pass (a prefill or a forward): one
    a layer, or for the encoder-decoder one an encoder layer and two a
    decoder layer (self-attention and cross-attention)."""
    return cfg.enc_layers + 2 * cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers


def k1_train_calls(cfg):
    """K1 launches of one training step's forward: ``k1_calls`` once, and
    once more where remat recomputes the layers for the backward (the
    decoder-only models; the encoder-decoder runs none, as the JAX model)."""
    return k1_calls(cfg) * (1 if cfg.family == "encdec" or cfg.remat == "none" else 2)


def model_batch(cfg, tokens, frames=None):
    """A model's batch: {tokens}, or for the encoder-decoder {frames,
    dec_tokens}."""
    if cfg.family == "encdec":
        return {"frames": frames, "dec_tokens": tokens}
    return {"tokens": tokens}


def image_grid_positions(text, side, extra):
    """(3, 1, text + side² + extra) M-RoPE positions (t, h, w): ``text``
    tokens at t = h = w = i, a side x side image at t = text, h = text +
    row, w = text + col, then ``extra`` tokens at t = h = w = their index,
    where ``decode_step`` puts a decoded token in all three streams, as the
    JAX model does."""
    import torch
    i = torch.arange(text)
    row, col = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    img = torch.stack([torch.full((side * side,), text), text + row.flatten(),
                       text + col.flatten()])
    after = torch.arange(text + side * side, text + side * side + extra)
    return torch.cat([i.expand(3, -1), img, after.expand(3, -1)], 1)[:, None].int()


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


def run_engine(root: Path) -> dict:
    """Phase 9 from the checkout at ``root``: ``run_all`` alone (its timed
    ratios are printed), then the crash demos, the dump's selftest and the
    lint at once, each a process of its own, killed if it outlives
    ``ENGINE_TIMEOUT``; every verdict asserted.  Returns each process's
    seconds, the demos' verdict lines, the figures' ratios and how many
    numbers were checked finite."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    out = root / "build" / "engine_bench.json"
    seconds = {}

    def run(commands):
        t0, procs, outs = time.perf_counter(), {}, {}
        try:
            for name, argv in commands.items():
                procs[name] = subprocess.Popen([sys.executable, *argv], cwd=root, env=env,
                                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                               text=True)
            for name, proc in procs.items():
                outs[name], stderr = proc.communicate(timeout=ENGINE_TIMEOUT)
                seconds[name] = time.perf_counter() - t0
                assert proc.returncode == 0, (name, proc.returncode, stderr[-2000:])
            return outs
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait()

    ran = run({"run_all": ["-m", "repro_torch.launch.engine_bench.run_all", "--out", str(out)]})
    print("  " + ran["run_all"].strip().splitlines()[-1])
    commands = {f"crash demo seed {seed}": ["examples/torch_crash_recovery_demo.py", str(seed)]
                for seed in ENGINE_DEMO_SEEDS}
    commands["dump selftest"] = ["-m", "repro_torch.obs.dump", "--selftest"]
    commands["lint"] = ["-m", "repro_torch.analysis.lint"]
    ran.update(run(commands))
    demo = {}
    for seed in ENGINE_DEMO_SEEDS:
        lines = ran[f"crash demo seed {seed}"].strip().splitlines()
        print(f"  crash demo seed {seed}: " + "; ".join(lines))
        verified = [line for line in lines if line.startswith("verified ")]
        assert len(verified) == 1 and verified[0].endswith(" acknowledged keys: 0 missing"), lines
        assert lines[-1] == "OK — every acknowledged write survived the crash", lines
        demo[seed] = verified[0]
    selftest = ran["dump selftest"].strip().splitlines()[-1]
    print("  dump " + selftest)
    assert selftest.startswith("selftest OK"), selftest
    print("  " + ran["lint"].strip())
    assert ran["lint"].startswith("lint: OK"), ran["lint"]

    figures = json.loads(out.read_text())
    numbers = []

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (key,))
        elif isinstance(tree, list):
            for i, sub in enumerate(tree):
                walk(sub, path + (i,))
        elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
            numbers.append((path, tree))

    walk(figures)
    bad = [path for path, x in numbers if not math.isfinite(x)]
    assert not bad, bad
    scans = [path for path, x in numbers if path[-1] == "log_full_scans" and x != 0]
    assert not scans, scans
    for path in ENGINE_COUNTS:
        value = figures
        for key in path:
            value = value[key]
        assert value > 0, (path, value)
    assert all(row["txns"] > 0 for row in figures["legacy"]["detail"])
    leg = figures["legacy"]
    ratios = {
        "sqlite_rollback_journal_x_vs_ssd": leg["sqlite_rollback_journal"]["speedup_x_vs_ssd"],
        "sqlite_wal_x_vs_ssd": leg["sqlite_wal"]["speedup_x_vs_ssd"],
        "rocksdb_style_x_vs_ssd": leg["rocksdb_style"]["speedup_x_vs_ssd"],
        "skew_rebalance_x": figures["skew"]["rebalance_speedup_x"],
        "cold_read_op_reduction_x": figures["cold_read"]["read_op_reduction_x"],
        "dualmode_byte_reduction_x": figures["dualmode"]["byte_reduction_x"],
        "coalesce_page_write_reduction_x": figures["coalesce"]["page_write_reduction_x"],
        "trickle_page_write_reduction_x": figures["trickle"]["page_write_reduction_x"]}
    print("  figures' ratios (printed, not held): "
          + ", ".join(f"{k} {v}" for k, v in ratios.items()))
    return {"seconds": seconds, "demo": demo, "ratios": ratios,
            "numbers_checked": len(numbers)}


def main() -> int:
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import NVCache, Policy, recover
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.configs.shapes import SHAPES, scale_shape
    from repro_torch.launch import (bench_ssd, ckpt_bench, decode_graph, dryrun, mesh_check,
                                    perf_probe, roofline, serve)
    from repro_torch.launch.profile_serve import PROMPT as SERVE_PROMPT
    from repro_torch.launch.profile_serve import one_card_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.bench_attention import cuda_ms, in_turns
    # the card's peaks and each kernel's own work, as the roofline counts them
    from repro_torch.launch.roofline import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS, attention_bound,
                                             attention_bwd_bound, quantize_bound, ssd_bound,
                                             ssd_bwd_bound)
    from repro_torch.models import moe
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW, tree_leaves
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
          "replaces": "src/repro/kernels/quantize.py:29", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}   # no single PyTorch call group-quantizes
    k3 = {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
          "replaces": "src/repro/kernels/ssd_scan.py:68", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}   # no single PyTorch call scans SSD
    # the JAX package has no SSD backward kernel (off the TPU it differentiates
    # its plain scan): the backward replaces that autodiff
    k3b = {"name": "ssd_scan_bwd", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/kernels/ops.py:43-47 (autodiff of ref.ssd_ref)",
           "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None}   # no PyTorch call either
    kernels = {"k1": (k1, fa.flash_attention_cuda), "k1b": (k1b, fa.flash_attention_bwd_cuda),
               "k2": (k2, quant.quantize_cuda), "k3": (k3, ssd.ssd_cuda),
               "k3b": (k3b, ssd.ssd_bwd_cuda)}
    for entry, _ in kernels.values():
        entry["paths"] = {}     # launches on each path the phases below drive

    def zero_counts():
        for _, fn in kernels.values():
            fn.launches = 0
        ssd.ssd_cuda.routes = dict.fromkeys(ssd.ROUTES, 0)
        ssd.ssd_bwd_cuda.routes = dict.fromkeys(ssd.ROUTES, 0)
        fa.flash_attention_cuda.routes = dict.fromkeys(fa.ROUTES, 0)
        fa.flash_attention_bwd_cuda.routes = dict.fromkeys(fa.ROUTES, 0)

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

    # the stashed earlier kernels: entry-point name in fa -> its entry point,
    # and "ssd" -> a function that runs the earlier K3
    parent = {}

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

    def load_parent(load, lib, src, dv_at):
        """A stashed K1 library's entry point.  An older source takes one
        head dim, without the Dv argument at position ``dv_at``: it is
        called with that argument dropped (it runs only Dv == D)."""
        entry = load(lib)
        parent["k1_takes_dv"] = "int D, int Dv" in src.read_text()
        if parent["k1_takes_dv"]:
            return entry
        entry.argtypes = entry.argtypes[:dv_at] + entry.argtypes[dv_at + 1:]
        return lambda *args: entry(*args[:dv_at], *args[dv_at + 1:])

    # ---------------------------------------------------------------- build
    def build_kernels():
        t0 = time.perf_counter()
        builders = {"k1": fa.build, "k1b": fa.build_bwd, "k2": quant.build, "k3": ssd.build,
                    "k3b": ssd.build_bwd}
        stashed = {"_entry": PARENT_DIR / "flash_attention.cu",
                   "_bwd_entry": PARENT_DIR / "flash_attention_bwd.cu",
                   "ssd": PARENT_DIR / "ssd_scan.cu"}
        if not (stashed["_entry"].exists() and stashed["_bwd_entry"].exists()):
            del stashed["_entry"], stashed["_bwd_entry"]
        stashed = {key: src for key, src in stashed.items() if src.exists()}
        for key, src in stashed.items():
            builders[key] = lambda src=src: _build.build(src)
        with ThreadPoolExecutor(len(builders)) as pool:   # one nvcc per source, together
            libs = dict(zip(builders, pool.map(lambda build_one: build_one(), builders.values())))
        if "_entry" in stashed:
            parent["_entry"] = load_parent(fa.load_fwd, libs["_entry"], stashed["_entry"], 12)
            parent["_bwd_entry"] = load_parent(fa.load_bwd, libs["_bwd_entry"],
                                               stashed["_bwd_entry"], 17)
        if "ssd" in stashed:
            parent["ssd"] = bench_ssd.runner(stashed["ssd"], libs["ssd"])
        if stashed:
            print(f"  stashed earlier kernels from {PARENT_DIR}: {sorted(stashed)}")
        libs = list(libs.values())
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
    def attention_inputs(gen, B, Sq, Skv, H, KV, D, Dv, dtype):
        dt = getattr(torch, dtype)
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                     for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv)))

    def sdpa_args(q, k, v):
        """q, k, v as scaled_dot_product_attention takes them: (B, H, S, D),
        the kv heads repeated to H."""
        G = q.shape[2] // k.shape[2]
        return (q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
                v.repeat_interleave(G, dim=2).transpose(1, 2))

    def sdpa_backend(qt, kt, vt, **mask):
        """The backend PyTorch's default dispatch of scaled_dot_product_attention
        picks for these inputs (v's head dim may differ from q's) and mask
        (``is_causal`` or ``attn_mask``, and ``enable_gqa``)."""
        from torch.nn.attention import SDPBackend
        names = {getattr(SDPBackend, n).value: n for n in dir(SDPBackend) if n.isupper()}
        return names.get(int(torch._fused_sdp_choice(qt, kt, vt, **mask)), "unknown")

    def time_forward(entry, shape, q, k, v, window=None, gqa=False, causal=True):
        """K1 and SDPA in turns (with the stashed earlier K1 when there is
        one), the plain version and the bound, at ``shape``, causal (or
        not) and with ``window`` when one is given, into ``entry``.  SDPA has no window
        argument: it gets the same mask as a boolean ``attn_mask``, and its
        output is held to K1's.  SDPA takes the kv heads repeated to H, or
        with ``gqa`` the compact ones with ``enable_gqa`` (one call on K1's
        own inputs), the repeated call then timed beside it."""
        qt, kt, vt = sdpa_args(q, k, v)
        if window:
            i = torch.arange(q.shape[1], device=dev)[:, None]
            j = torch.arange(k.shape[1], device=dev)[None]
            mask = {"attn_mask": (j <= i) & (j > i - window)}
        else:
            mask = {"is_causal": causal}
        fns = [("kernel", lambda: fa.flash_attention_cuda(q, k, v, causal=causal, window=window)),
               ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, **mask))]
        library = (qt, kt, vt), mask
        if gqa:
            library = (qt, k.transpose(1, 2), v.transpose(1, 2)), {**mask, "enable_gqa": True}
            fns.insert(1, ("sdpa enable_gqa", lambda: F.scaled_dot_product_attention(
                *library[0], **library[1])))
        got = fns[0][1]().float()
        for name, fn in fns[1:]:
            lib = fn().transpose(1, 2).float()
            if not bool(((got - lib).abs() <= TOL["bfloat16"] * (1 + lib.abs())).all()):
                raise AssertionError(f"{name} and K1 disagree at {shape}, causal {causal}, "
                                     f"window {window}")
        del got, lib
        earlier = "_entry" in parent and (parent["k1_takes_dv"] or shape["D"] == shape["Dv"])
        if earlier:
            fns.append(("earlier kernel", with_entry("_entry", parent["_entry"], fns[0][1])))
        times = in_turns(fns, 20)
        entry["ms"] = sum(times["kernel"]) / 2
        entry["library_ms"] = sum(times[fns[1][0]]) / 2
        entry["sdpa_backend"] = backend = sdpa_backend(*library[0], **library[1])
        if gqa:
            entry["sdpa_repeated_kv_ms"] = sum(times["sdpa"]) / 2
        if earlier:
            entry["earlier_ms"] = sum(times["earlier kernel"]) / 2
        entry["plain_ms"] = cuda_ms(
            lambda: ref.attention_ref(q, k, v, causal=causal, window=window or 0), 5)
        entry["bound_ms"], entry["bound_by"] = attention_bound(
            *shape.values(), 2, causal, window or 0, PEAK_BF16_FLOPS)
        print(f"  K1 at {shape} bf16 causal {causal} window {window}, in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f" (SDPA backend {backend}); plain {entry['plain_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")

    def plain_attention(q, k, v, **mask):
        """attention_ref one batch row at a time: the f32 scores of a whole
        train_4k batch would take tens of GB."""
        return torch.cat([ref.attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], **mask)
                          for b in range(q.shape[0])])

    def plain_grads(q, k, v, do, **mask):
        """dq, dk, dv by autograd of attention_ref, one batch row at a time."""
        rows = []
        for b in range(q.shape[0]):
            leaves = [t[b:b + 1].clone().requires_grad_() for t in (q, k, v)]
            rows.append(torch.autograd.grad(ref.attention_ref(*leaves, **mask), leaves,
                                            do[b:b + 1]))
        return [torch.cat(g) for g in zip(*rows)]

    def check_kernels():
        gen = torch.Generator(dev).manual_seed(0)
        bad, errs, slices = [], {}, {}
        for case in (SWEEP + MODEL_CASES + D128_CASES + MLA_CASES + HYMBA_CASES
                     + D128_SERVE_CASES + GRANITE_SMOKE_CASES + MOE_SMOKE_CASES
                     + WHISPER_CASES + WHISPER_SMOKE_CASES):
            B, Sq, Skv, H, KV, D, Dv, dtype, causal, window = case
            q, k, v = attention_inputs(gen, B, Sq, Skv, H, KV, D, Dv, dtype)
            want_route = fa.route(q.dtype, D, Dv)
            before = dict(fa.flash_attention_cuda.routes)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            took = [r for r, n in fa.flash_attention_cuda.routes.items() if n != before[r]]
            want = plain_attention(q, k, v, causal=causal, window=window or 0)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            errs[case] = float(diff.max())
            ok = (bool((diff <= TOL[dtype] * (1 + want.float().abs())).all())
                  and got.shape == (B, Sq, H, Dv) and took == [want_route])
            print(f"  K1 B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} Dv={Dv} {dtype} "
                  f"causal={causal} window={window}: route {took} (want {want_route}), "
                  f"max_abs_err={errs[case]:.3e} tol={TOL[dtype]} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case in (MODEL_CASES[0], MLA_CASES[0], *HYMBA_CASES[:2],
                        *D128_SERVE_CASES[:len(D128_SERVE)], WHISPER_CASES[0]):
                slices[case] = q, k, v
            del q, k, v, got, want, diff
        k1["max_abs_err"] = errs[MODEL_CASES[0]]   # at llama's serving prefill shape
        k1["mla"] = {"shape": MLA, "max_abs_err": errs[MLA_CASES[0]]}
        time_forward(k1, SLICE, *slices[MODEL_CASES[0]])
        time_forward(k1["mla"], MLA, *slices[MLA_CASES[0]])
        # hymba's windowed layers (29 of 32) and its global ones
        for key, case in (("hymba", HYMBA_CASES[0]), ("hymba_global", HYMBA_CASES[1])):
            k1[key] = {"shape": HYMBA, "window": case[-1], "max_abs_err": errs[case]}
            time_forward(k1[key], HYMBA, *slices[case], window=case[-1])
        # head dim 128 at minitron's, granite's, qwen2-vl's and qwen3-moe's prefill
        for arch, case in zip(D128_SERVE, D128_SERVE_CASES):
            shape = dict(zip(("B", "Sq", "Skv", "H", "KV", "D", "Dv"), case[:7]))
            k1[arch] = {"shape": shape, "max_abs_err": errs[case]}
            time_forward(k1[arch], shape, *slices.pop(case), gqa=True)
        # whisper-small's encoder: non-causal over 1500 frames; its decoder
        # self and cross shapes checked above
        k1["whisper"] = {"shape": WHISPER, "causal": False,
                         "max_abs_err": errs[WHISPER_CASES[0]],
                         "max_abs_err_cross": errs[WHISPER_CASES[2]]}
        time_forward(k1["whisper"], WHISPER, *slices.pop(WHISPER_CASES[0]), causal=False)
        if bad:
            raise AssertionError(f"K1 disagrees with attention_ref in {bad}")

    def check_k1_long():
        """K1 at llama3.2-1b's prefill_32k shape (``LLAMA_32K``): each batch
        row's sampled query blocks ``ROWS_32K`` against the plain version
        over the keys they see; then K1 and SDPA in turns, the bound, and
        the plain version's time over those blocks."""
        shape = LLAMA_32K
        gen = torch.Generator(dev).manual_seed(4)
        q, k, v = attention_inputs(gen, *shape.values(), "bfloat16")
        before = dict(fa.flash_attention_cuda.routes)
        got = fa.flash_attention_cuda(q, k, v, causal=True)
        took = [r for r, n in fa.flash_attention_cuda.routes.items() if n != before[r]]

        def plain_rows():
            return [[ref.attention_ref(q[b:b + 1, lo:hi], k[b:b + 1, :hi], v[b:b + 1, :hi],
                                       causal=True, q_start=lo) for lo, hi in ROWS_32K]
                    for b in range(shape["B"])]

        ok = took == ["wgmma"] and got.shape == (*q.shape[:3], shape["Dv"])
        blocks = {f"{lo}-{hi}": {"max_abs_err": 0.0, "rel_err": 0.0} for lo, hi in ROWS_32K}
        for b, row in enumerate(plain_rows()):
            for (lo, hi), want in zip(ROWS_32K, row):
                want = want.float()
                d = got[b:b + 1, lo:hi].float() - want
                block = blocks[f"{lo}-{hi}"]
                block["max_abs_err"] = max(block["max_abs_err"], float(d.abs().max()))
                block["rel_err"] = max(block["rel_err"], float(d.norm() / want.norm()))
                ok &= bool((d.abs() <= TOL["bfloat16"] * (1 + want.abs())).all())
        err = max(block["max_abs_err"] for block in blocks.values())
        ok &= all(block["rel_err"] <= REL_32K for block in blocks.values())
        for name, block in blocks.items():
            print(f"  K1 at S 32768, query rows {name}: max |d| {block['max_abs_err']:.3e}, "
                  f"largest ||d|| / ||ref|| over the batch rows {block['rel_err']:.3e} "
                  f"(tol {REL_32K})")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = {"is_causal": True, "enable_gqa": True}
        lib = F.scaled_dot_product_attention(qt, kt, vt, **mask).transpose(1, 2)
        for lo, hi in ROWS_32K:
            a, b = got[:, lo:hi].float(), lib[:, lo:hi].float()
            ok &= bool(((a - b).abs() <= TOL["bfloat16"] * (1 + b.abs())).all())
        del got, lib
        times = in_turns([("kernel", lambda: fa.flash_attention_cuda(q, k, v, causal=True)),
                          ("sdpa enable_gqa", lambda: F.scaled_dot_product_attention(
                              qt, kt, vt, **mask))], 3)
        entry = k1["llama_32k"] = {"shape": shape, "rows": ROWS_32K, "max_abs_err": err,
                                   "blocks": blocks}
        entry["ms"] = sum(times["kernel"]) / 2
        entry["library_ms"] = sum(times["sdpa enable_gqa"]) / 2
        entry["sdpa_backend"] = sdpa_backend(qt, kt, vt, **mask)
        entry["plain_rows_ms"] = cuda_ms(plain_rows, 1, warmup=0)
        entry["bound_ms"], entry["bound_by"] = attention_bound(
            *shape.values(), 2, True, 0, PEAK_BF16_FLOPS)
        print(f"  K1 at {shape} bf16 causal: route {took}, max_abs_err {err:.3e} on query rows "
              f"{ROWS_32K} of every batch row (tol {TOL['bfloat16']}); in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f" (SDPA backend {entry['sdpa_backend']}); plain over the sampled rows "
              f"{entry['plain_rows_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"K1 disagrees with attention_ref or SDPA at {shape}")

    def projection_views(x, B, C):
        """x, B and C as views of one (b, s, h p + 2 g n) row, as
        ``ssm_forward`` hands them over; their layout asserted."""
        hp, gn = x.shape[2] * x.shape[3], B.shape[2] * B.shape[3]
        views = bench_ssd.projection_views(x, B, C)
        assert [t.storage_offset() for t in views] == [0, hp, hp + gn]
        assert all(t.stride(1) == hp + 2 * gn for t in views)
        return views

    def time_ssd(entry, shape, args):
        """K3 and its plain version in turns (with the stashed earlier K3
        when there is one) and the bound, at ``shape``, into ``entry``."""
        chunk = shape["chunk"]
        fns = [("kernel", lambda: ssd.ssd_cuda(*args, chunk=chunk)),
               ("plain", lambda: ref.ssd_ref(*args, chunk=chunk))]
        if "ssd" in parent:
            fns.append(("earlier kernel", lambda: parent["ssd"](*args, chunk=chunk)))
        times = in_turns(fns, 20)
        entry["ms"] = sum(times["kernel"]) / 2
        entry["plain_ms"] = sum(times["plain"]) / 2
        if "ssd" in parent:
            entry["earlier_ms"] = sum(times["earlier kernel"]) / 2
        # the main path's route (bf16) at the bf16 tensor-core peak; the fma
        # route's bound (fp32 operations) beside it
        entry["bound_ms"], entry["bound_by"] = ssd_bound(*shape.values(), 2, PEAK_BF16_FLOPS)
        bound_f32, by_f32 = ssd_bound(*shape.values(), 2, PEAK_F32_FLOPS)
        print(f"  K3 at {shape} bf16 (wgmma route), in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f"; library none, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, bf16), "
              f"{bound_f32:.4f} ms ({by_f32}, at the fp32 peak)")

    def check_ssd():
        gen = torch.Generator(dev).manual_seed(0)
        bad, errs, timed = [], {}, {}
        for case in (SSD_SWEEP + SSD_MODEL_CASES + HYMBA_SSD_CASES
                     + [SSD_32K_CASE, SSD_32K_CUT_CASE]):
            b, s, h, p, g, n, chunk, dtype = case
            cdt = getattr(torch, dtype)
            x, dt, A, B, C = bench_ssd.inputs(gen, dev, b, s, h, p, g, n, cdt)
            if case in (HYMBA_SSD_CASES[0], SSD_32K_CUT_CASE):
                # 3232 wide for hymba (x at 0, B at 3200, C at 3216), 3328 for mamba2
                x, B, C = projection_views(x, B, C)
            want = ssd_route_wanted(p, n, chunk, dtype)
            before = dict(ssd.ssd_cuda.routes)
            y, st = ssd.ssd_cuda(x, dt, A, B, C, chunk=chunk)
            took = [r for r, k in ssd.ssd_cuda.routes.items() if k != before[r]]
            ok = took == [want] and ssd.ssd_route(x, B, C, chunk) == want
            ey = es = 0.0
            for r in range(b):   # ssd_ref's f32 copies of a whole b = 16 batch take ~45 GB
                wy, wst = ref.ssd_ref(x[r:r + 1], dt[r:r + 1], A, B[r:r + 1], C[r:r + 1],
                                      chunk=chunk)
                dy, ds = (y[r:r + 1].float() - wy.float()).abs(), (st[r:r + 1] - wst).abs()
                ey, es = max(ey, float(dy.max())), max(es, float(ds.max()))
                ok &= (bool((dy <= SSD_TOL[dtype] * (1 + wy.float().abs())).all())
                       and bool((ds <= SSD_TOL["float32"] * (1 + wst.abs())).all()))
            errs[case] = max(ey, es)
            print(f"  K3 b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} {dtype}: route "
                  f"{took} (want {want}), max_abs_err y {ey:.3e} state {es:.3e} tol "
                  f"{SSD_TOL[dtype]}/{SSD_TOL['float32']} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case in (SSD_MODEL_CASES[0], HYMBA_SSD_CASES[0], SSD_32K_CASE):
                timed[case] = x, dt, A, B, C
            del x, dt, A, B, C, y, st, wy, wst, dy, ds
        k3["max_abs_err"] = errs[SSD_MODEL_CASES[0]]   # at the serving prefill shape
        time_ssd(k3, SSD_SLICE, timed[SSD_MODEL_CASES[0]])
        k3["hymba"] = {"shape": HYMBA_SSD, "layout": "views of one 3232-wide row",
                       "max_abs_err": errs[HYMBA_SSD_CASES[0]]}
        time_ssd(k3["hymba"], HYMBA_SSD, timed[HYMBA_SSD_CASES[0]])
        k3["mamba2_32k"] = {"shape": SSD_32K, "max_abs_err": errs[SSD_32K_CASE],
                            "max_abs_err_b16_views": errs[SSD_32K_CUT_CASE]}
        time_ssd(k3["mamba2_32k"], SSD_32K, timed.pop(SSD_32K_CASE))
        if bad:
            raise AssertionError(f"K3 disagrees with ssd_ref in {bad}")

    def check_ssd_bwd():
        """K3's backward against ``ssd_bwd_ref`` (autograd of the plain
        version, the gradient in float32 and cast once) at SSD_BWD_CASES,
        each on the route it must take (``ssd_bwd_cuda.routes``); run twice at
        mamba2's train shape (dx bit-equal: it has no atomics; dB, dC, dA and
        ddt add with them); then both routes (wgmma, and fma on the same
        inputs) timed in turns beside the plain version at mamba2's and
        hymba's, with the bound (bf16 tensor-core peak, and the fp32 one the
        fma route's FMAs run at)."""
        gen = torch.Generator(dev).manual_seed(5)
        bad, errs, timed = [], {}, {}
        for case in SSD_BWD_CASES:
            b, s, h, p, g, n, chunk, dtype, layout, final = case
            x, dt, A, B, C = bench_ssd.inputs(gen, dev, b, s, h, p, g, n, getattr(torch, dtype))
            if layout == "views":
                x, B, C = projection_views(x, B, C)
            dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(x.dtype)
            dfin = torch.randn((b, h, p, n), generator=gen, device=dev) if final else None
            want_route = ssd_route_wanted(p, n, chunk, dtype)
            before = dict(ssd.ssd_bwd_cuda.routes)
            got = ssd.ssd_bwd_cuda(x, dt, A, B, C, dy, dfin, chunk=chunk)
            took = [r for r, k in ssd.ssd_bwd_cuda.routes.items() if k != before[r]]
            want = ref.ssd_bwd_ref(x, dt, A, B, C, dy, dfin, chunk=chunk)
            torch.cuda.synchronize()
            ok = took == [want_route] and ssd.ssd_bwd_route(x, B, C, dy, chunk) == want_route
            err = {}
            for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
                d = (a.float() - w.float()).abs()
                err[name] = float((d / (1 + w.float().abs())).max())
                ok &= a.dtype == w.dtype and a.shape == w.shape
                if name != "dA":
                    ok &= bool((d <= SSD_TOL[dtype] * (1 + w.float().abs())).all())
            rel = float((got[2] - want[2]).norm() / want[2].norm())
            ok &= rel <= SSD_BWD_DA_REL[dtype]
            errs[case] = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
            print(f"  K3 bwd b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} {dtype} {layout}"
                  f"{' d(final state)' if final else ''}: route {took} (want {want_route}), max "
                  f"|d|/(1+|ref|) " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" (tol {SSD_TOL[dtype]}; dA per element printed, held by ||d||/||ref|| "
                  f"{rel:.3e} <= {SSD_BWD_DA_REL[dtype]}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case in SSD_BWD_CASES[:2]:
                timed[case] = x, dt, A, B, C, dy
            del x, dt, A, B, C, dy, got, want
        x, dt, A, B, C, dy = timed[SSD_BWD_CASES[0]]
        runs = [ssd.ssd_bwd_cuda(x, dt, A, B, C, dy, chunk=SSD_SLICE["chunk"]) for _ in range(2)]
        torch.cuda.synchronize()
        gaps = {name: float((a.float() - b.float()).abs().max())
                for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), *runs)}
        print(f"  K3 bwd run twice at {SSD_SLICE} (wgmma route): max |gap| {gaps} (dx has no "
              f"atomics; ddt, dA, dB and dC sum with fp32 atomics)")
        if not torch.equal(runs[0][0], runs[1][0]):
            bad.append("dx not bit-equal over two runs")
        del runs
        k3b["max_abs_err"] = errs[SSD_BWD_CASES[0]]   # at mamba2's train shape
        k3b["hymba"] = {"shape": HYMBA_SSD, "layout": "views of one 3232-wide row",
                        "max_abs_err": errs[SSD_BWD_CASES[1]]}
        bwd_entry = ssd._bwd_entry()
        for entry, shape, case in ((k3b, SSD_SLICE, SSD_BWD_CASES[0]),
                                   (k3b["hymba"], HYMBA_SSD, SSD_BWD_CASES[1])):
            x, dt, A, B, C, dy = timed.pop(case)
            chunk = shape["chunk"]
            stream = torch.cuda.current_stream().cuda_stream
            times = in_turns([("wgmma", lambda: ssd.ssd_bwd_cuda(x, dt, A, B, C, dy, chunk=chunk)),
                              ("fma", lambda: ssd.launch_bwd(bwd_entry, x, dt, A, B, C, dy, None,
                                                             chunk, stream, "fma")),
                              ("plain", lambda: ref.ssd_bwd_ref(x, dt, A, B, C, dy, chunk=chunk))],
                             5)
            entry["ms"] = sum(times["wgmma"]) / 2
            entry["fma_ms"] = sum(times["fma"]) / 2
            entry["plain_ms"] = sum(times["plain"]) / 2
            entry["bound_ms"], entry["bound_by"] = ssd_bwd_bound(*shape.values(), 2,
                                                                 PEAK_BF16_FLOPS)
            bound_f32, by_f32 = ssd_bwd_bound(*shape.values(), 2, PEAK_F32_FLOPS)
            entry["bound_f32_ms"] = bound_f32
            print(f"  K3 bwd at {shape} bf16, in turns: "
                  + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
                  + f"; wgmma {entry['fma_ms'] / entry['ms']:.2f}x faster than fma; library "
                  f"none, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, bf16), "
                  f"{bound_f32:.4f} ms ({by_f32}, at the fp32 peak)")
            del x, dt, A, B, C, dy
        if bad:
            raise AssertionError(f"K3 backward disagrees with ssd_bwd_ref in {bad}")

    def time_backward(entry, shape, q, k, v, o, lse, do):
        """Two K1 backward runs against each other (dq adds with atomics);
        then the backward and SDPA's in turns (with the stashed earlier one
        when there is one), the plain version and the bound, into ``entry``.
        Returns whether the two runs agree."""
        runs = [fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True) for _ in range(2)]
        torch.cuda.synchronize()
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*runs))
        agree = all(bool(((a.float() - b.float()).abs()
                          <= BWD_TOL["bfloat16"] * (1 + b.float().abs())).all())
                    for a, b in zip(*runs))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"  K1 bwd run twice at {shape}: max |gap| {gap:.3e}, bitwise "
              f"{'equal' if same else 'different'}, tol {BWD_TOL['bfloat16']} "
              f"{'ok' if agree else 'MISMATCH'}")
        del runs
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*leaves, causal=True)
        entry["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 3, warmup=1)
        del out, leaves
        # SDPA over the kv heads repeated to H (as the forward's yardstick),
        # as its default dispatch picks; only its backward is timed
        qt, kt, vt = (t.detach().requires_grad_() for t in sdpa_args(q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        fns = [("kernel", lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)),
               ("sdpa backward", lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                             retain_graph=True))]
        earlier = "_bwd_entry" in parent and (parent["k1_takes_dv"] or shape["D"] == shape["Dv"])
        if earlier:
            fns.append(("earlier kernel", with_entry("_bwd_entry", parent["_bwd_entry"],
                                                     fns[0][1])))
        times = in_turns(fns, 20)
        entry["ms"] = sum(times["kernel"]) / 2
        entry["library_ms"] = sum(times["sdpa backward"]) / 2
        entry["sdpa_backend"] = backend = sdpa_backend(qt, kt, vt)
        if earlier:
            entry["earlier_ms"] = sum(times["earlier kernel"]) / 2
        entry["bound_ms"], entry["bound_by"] = attention_bwd_bound(
            *shape.values(), 2, True, 0, PEAK_BF16_FLOPS)
        print(f"  K1 bwd at {shape} bf16 causal, in turns: "
              + ", ".join(f"{name} {a:.4f}/{b:.4f} ms" for name, (a, b) in times.items())
              + f" (SDPA backend {backend}); plain {entry['plain_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        return agree

    def check_attention_bwd():
        gen = torch.Generator(dev).manual_seed(2)
        bad, errs, timed = [], {}, {}
        for case in (SWEEP + BWD_CASES + D128_CASES + MLA_BWD_CASES + MLA_CASES[5:]
                     + HYMBA_BWD_CASES + GRANITE_SMOKE_CASES + MOE_SMOKE_CASES[:6]
                     + GRANITE_BWD_CASES + WHISPER_BWD_CASES + WHISPER_SMOKE_CASES):
            B, Sq, Skv, H, KV, D, Dv, dtype, causal, window = case
            q, k, v = attention_inputs(gen, B, Sq, Skv, H, KV, D, Dv, dtype)
            do = torch.randn((B, Sq, H, Dv), generator=gen, device=dev).to(q.dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             return_lse=True)
            want_route = fa.route(q.dtype, D, Dv)
            before = dict(fa.flash_attention_bwd_cuda.routes)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                              window=window)
            took = [r for r, n in fa.flash_attention_bwd_cuda.routes.items() if n != before[r]]
            want = plain_grads(q, k, v, do, causal=causal, window=window or 0)
            torch.cuda.synchronize()
            err, ok = 0.0, took == [want_route]
            for g, w in zip(got, want):
                diff = (g.float() - w.float()).abs()
                err = max(err, float(diff.max()))
                ok &= g.shape == w.shape and bool((diff <= BWD_TOL[dtype] * (1 + w.float().abs())).all())
            errs[case] = err
            print(f"  K1 bwd B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} Dv={Dv} {dtype} "
                  f"causal={causal} window={window}: route {took} (want {want_route}), "
                  f"max_abs_err dq/dk/dv {err:.3e} tol {BWD_TOL[dtype]} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(case)
            if case in (BWD_CASES[0], MLA_BWD_CASES[0], GRANITE_BWD_CASES[0]):
                timed[case] = q, k, v, o, lse, do
            del want, got
        k1b["max_abs_err"] = errs[BWD_CASES[0]]    # at llama's training shape
        k1b["mla"] = {"shape": MLA, "max_abs_err": errs[MLA_BWD_CASES[0]]}
        k1b["hymba"] = {"shape": HYMBA, "window": HYMBA_WINDOW,
                        "max_abs_err": errs[HYMBA_BWD_CASES[0]]}   # checked, not timed
        k1b["granite"] = {"shape": GRANITE, "plan": "row sums, then P and dS as two bf16 terms",
                          "max_abs_err": errs[GRANITE_BWD_CASES[0]]}
        k1b["whisper"] = {"shape": WHISPER, "causal": False,   # checked, not timed
                          "max_abs_err": errs[WHISPER_BWD_CASES[0]],
                          "max_abs_err_cross": max(errs[c] for c in WHISPER_BWD_CASES[1:])}
        for entry, shape, case in ((k1b, TRAIN, BWD_CASES[0]), (k1b["mla"], MLA, MLA_BWD_CASES[0]),
                                   (k1b["granite"], GRANITE, GRANITE_BWD_CASES[0])):
            if not time_backward(entry, shape, *timed.pop(case)):
                bad.append(f"run twice at {shape}")
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
        k2["ms"] = cuda_ms(lambda: quant.quantize_cuda(emb, group=group), 20)
        k2["plain_ms"] = cuda_ms(lambda: ref.quantize_ref(emb, group=group), 5)
        k2["bound_ms"], k2["bound_by"] = quantize_bound(emb.numel(), group, 4)
        print(f"  K2 at the embedding leaf ({emb.numel()} f32 values, group {group}): kernel "
              f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, library none, bound "
              f"{k2['bound_ms']:.4f} ms ({k2['bound_by']})")
        if bad:
            raise AssertionError(f"K2 differs from quantize_ref in {bad}")

    phase("kernels K1", check_kernels)
    phase("kernels K1 at prefill_32k", check_k1_long)
    phase("kernels K1 backward", check_attention_bwd)
    phase("kernels K2", check_quantize)
    phase("kernels K3", check_ssd)
    phase("kernels K3 backward", check_ssd_bwd)

    # ---------------------------------------------------------------- serve
    def serve_full_width(arch):
        cfg = one_card_config(arch)   # granite-20b, qwen3-moe-30b-a3b: bfloat16 parameters
        B, P, T = 4, SERVE_PROMPT.get(arch, 2048), 32   # whisper-small: 1500 frames
        torch.cuda.empty_cache()      # the last model's blocks: room for this one's
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        graphs0 = dataclasses.asdict(decode_graph.COUNTS)
        with moe.count_drops() as drops:   # (token, k) pairs over capacity (MoE)
            res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                              "--tokens", str(T), "--seed", "0"], cfg=cfg)
        counts = read_counts(f"serve {arch}")
        graphs = {k: v - graphs0[k] for k, v in dataclasses.asdict(decode_graph.COUNTS).items()}
        own = ARCHS[arch]
        for key in own:   # the last arch's counts stand: K1's at whisper-small, K3's at hymba
            kernels[key][0]["launches"] = counts[key]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  serve {arch} ({cfg.param_dtype} parameters): prefill "
              f"{res.prefill_s * 1e3:.2f} ms, decode {B * T / res.decode_s:.1f} tokens/s "
              f"({res.decode_s / T * 1e3:.2f} ms/step, the graph's capture included where "
              f"there is one: decode graph counts {graphs}), peak memory {peak:.2f} GiB, "
              f"launches {counts}")
        graphed = cfg.family not in decode_graph.EAGER_FAMILIES
        assert graphs == {"captures": int(graphed), "recaptures": 0, "replays": T * graphed,
                          "eager_steps": T * (not graphed)}, graphs
        if cfg.family == "moe":   # a decode step's capacity of 4 drops nothing
            # random weights collapse the routing with depth (the attention
            # output's shared part leads every token's router input), so the
            # later layers drop most pairs (tests/test_torch_moe.py::
            # test_random_weights_collapse_the_routing_with_depth)
            per_layer = [int(n) / (B * P * cfg.top_k) for n in drops[:cfg.n_layers]]
            pairs = B * P * cfg.top_k * cfg.n_layers
            print(f"  {int(sum(drops))} of the prefill's {pairs} (token, k) pairs dropped over "
                  f"capacity {moe.moe_capacity(cfg, min(cfg.moe_group, B * P))} "
                  f"({len(drops)} MoE calls, decode {int(sum(drops[cfg.n_layers:]))}); by "
                  f"layer: " + ", ".join(f"{x:.3f}" for x in per_layer))
            assert len(drops) == cfg.n_layers * (1 + T) and int(sum(drops[cfg.n_layers:])) == 0
        per_prefill = {"k1": k1_calls(cfg), "k3": cfg.n_layers}
        want = {key: per_prefill[key] if key in own else 0 for key in kernels}
        assert counts == want, f"{arch}: kernel launches {counts} in one request, want {want}"
        # every prefill call on the wgmma route (K1: bf16 at head dims 64 or
        # 128, or MLA's 96 and 64; K3: bf16 at p 64 and n 128 or 16 on the views)
        for key in own:
            routes = dict((ssd.ssd_cuda if key == "k3" else fa.flash_attention_cuda).routes)
            print(f"  {key.upper()} routes: {routes}")
            assert routes == {**dict.fromkeys(routes, 0), "wgmma": per_prefill[key]}, routes
        assert res.tokens.shape == (B, T) and bool(torch.isfinite(res.logits).all())
        assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab
        lines = [json.loads(x) for x in res.log.decode().splitlines()]
        assert lines == [{"batch": B, "prompt_len": P},
                         {"completed": B * T, "seconds": lines[1]["seconds"]}], lines
        print(f"  request log read back: {lines}")

    for arch in ARCHS:
        phase(f"serve {arch}", lambda: serve_full_width(arch))

    # --------------------------------------------------------------- decode
    def decode_matches_forward(arch, cfg=None):
        """Teacher-forced decode against the forward, for each of the arch's
        ``DECODE_RUNS``: a prefill of ``P`` tokens, then a decode step for
        each of the others up to ``S``, each step's logits against the
        forward's over all ``S`` tokens; with an image grid, the forward and
        the prefill take its M-RoPE positions.  ``cfg`` in place of the
        arch's one-card config (granite-20b and qwen3-moe-30b-a3b: bfloat16
        parameters, which float32 compute casts up a layer at a time); an
        MoE model at capacity factor E / k, where its forward drops no pair."""
        cfg = one_card_config(arch) if cfg is None else cfg
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        torch.cuda.empty_cache()
        plain_scan = "k3" in ARCHS.get(arch, ())
        for P, S, grid in DECODE_RUNS.get(arch, ((1, 64, None),)):
            full_f32 = None
            pos = {}
            if grid:
                pos = {"positions": image_grid_positions(*grid, S - P).to(dev)}
                assert pos["positions"].shape == (3, 1, S) and P == grid[0] + grid[1] ** 2
            for dtype in ("float32", "bfloat16"):
                model = build(dataclasses.replace(cfg, compute_dtype=dtype))
                gen = torch.Generator(dev).manual_seed(1)
                with torch.inference_mode():
                    params = model.init(gen)
                    toks = torch.randint(1, cfg.vocab - 1, (1, S), generator=gen, device=dev,
                                         dtype=torch.int32)
                    frames = (torch.randn((1, WHISPER_FRAMES, cfg.d_model), generator=gen,
                                          device=dev) if cfg.family == "encdec" else None)
                    before = dict(ssd.ssd_cuda.routes)
                    with moe.count_drops() as drops:
                        full, _ = model.forward(params, {**model_batch(cfg, toks, frames), **pos})
                    assert int(sum(drops)) == 0, f"{int(sum(drops))} pairs dropped"
                    if dtype == "float32" and plain_scan:
                        kernel_ssd, ops.ssd = ops.ssd, ref.ssd_ref
                        try:
                            plain_full, _ = model.forward(params, {"tokens": toks})
                        finally:
                            ops.ssd = kernel_ssd
                    if dtype == "float32" and grid:   # the grid's streams reach the logits
                        text_full, _ = model.forward(params, {"tokens": toks})
                        moved = float((text_full - full).abs().max())
                        print(f"  {arch}: the image grid's positions move the forward's "
                              f"logits by up to {moved:.4e} from text positions")
                        assert moved > 10 * DECODE_TOL[dtype], moved
                        del text_full
                    _, cache = model.prefill(
                        params, {**model_batch(cfg, toks[:, :P], frames),
                                 **{k: v[..., :P] for k, v in pos.items()}}, S + 2)
                    # K3 per layer for the forward and the prefill (a short
                    # one padded to 64 rows): the wgmma route in bf16, fma in f32
                    took = {r: k - before[r] for r, k in ssd.ssd_cuda.routes.items()}
                    want = dict.fromkeys(ssd.ROUTES, 0)
                    if plain_scan:
                        want["wgmma" if dtype == "bfloat16" else "fma"] = 2 * cfg.n_layers
                    assert took == want, f"{dtype}: K3 routes {took}, want {want}"
                    outs = []
                    for t in range(P, S):
                        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
                        outs.append(lg[:, 0])
                    dec = torch.stack(outs, 1)
                assert bool(torch.isfinite(dec).all())
                diff = (dec - full[:, P:S]).abs()
                gap, scale = float(diff.max()), float(full.abs().max())
                if dtype == "float32":
                    full_f32 = full
                what = (f"{cfg.arch} {dtype}, prefill {P}"
                        f"{' (text and image grid)' if grid else ''}"
                        f"{f' over {WHISPER_FRAMES} frames' if frames is not None else ''} "
                        f"then {S - P} steps")
                if dtype == "bfloat16" and arch in NOISE_HELD:
                    noise = float((full - full_f32).abs().mean())
                    print(f"  decode vs forward, {what}: mean |logit gap| "
                          f"{float(diff.mean()):.4e}, max {gap:.4e} (max |logit| {scale:.3f}), "
                          f"held to {NOISE_HELD[arch]}x the bf16 forward's mean |gap| to f32 "
                          f"{noise:.4e}")
                    assert float(diff.mean()) <= NOISE_HELD[arch] * noise, (
                        f"{what}: decode/forward gap {diff.mean()}")
                else:
                    plain = (f", with the plain scan "
                             f"{float((dec - plain_full[:, P:S]).abs().max()):.4e}"
                             if plain_scan else "")
                    print(f"  decode vs forward, {what}: max |logit gap| {gap:.4e}{plain} "
                          f"(max |logit| {scale:.3f}), tol {DECODE_TOL[dtype]}")
                    assert gap < DECODE_TOL[dtype], f"{what}: decode/forward gap {gap}"
                del params, cache
        torch.cuda.empty_cache()

    for arch in ARCHS:
        phase(f"decode {arch}", lambda: decode_matches_forward(arch))
    phase("decode arctic-480b SMOKE",
          lambda: decode_matches_forward("arctic-480b", get_smoke("arctic-480b")))

    # ---------------------------------------------------------------- train
    def train_full_width(arch):
        """``arch`` at full width (TRAIN_ARCHS: llama3.2-1b, and mamba2-780m
        and hymba-1.5b through K3 and its backward) for TRAIN_STEPS steps at
        batch 4 x 2048: exact launches a step, finite and falling loss."""
        cfg = get_config(arch)
        model, opt = build(cfg), AdamW(lr=TRAIN_LR)
        B, S = TRAIN["B"], TRAIN["Sq"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = tsteps.init_train_state(model, opt, torch.Generator(dev).manual_seed(0))
        shapes = {key: tuple(t.shape) for key, t in flatten(state["params"])}
        if arch == "llama3.2-1b":
            assert shapes == train_leaf_shapes(cfg), shapes
        step_fn = tsteps.make_train_step(model, opt, compress=True)
        pipe = SyntheticTokens(cfg.vocab, B, S, seed=0)
        # per step: K1 and K3 once per layer in the forward and once more when
        # the "dots" remat recomputes the layer for the backward; their
        # backwards once per layer; K2 once per gradient leaf
        want = {**train_launches(cfg, TRAIN_ARCHS[arch]), "k2": len(shapes)}
        print(f"  {arch}: remat {cfg.remat!r}, compute {cfg.compute_dtype}, params "
              f"{cfg.param_dtype}, launches wanted per step {want}")
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
        counts = read_counts(f"train {arch}")
        if want["k3b"]:   # every K3 backward of the full-width step on its wgmma route
            routes = dict(ssd.ssd_bwd_cuda.routes)
            print(f"  {arch}: K3 backward routes {routes}")
            assert routes == {**dict.fromkeys(routes, 0), "wgmma": counts["k3b"]}, routes
        # until phase 7's mesh train steps set the kernels line's counts
        for key in ("k1b", "k2") if arch == "llama3.2-1b" else ("k3b",) if arch == "mamba2-780m" else ():
            kernels[key][0]["launches"] = counts[key]
        warm = times[1:]
        train_runs[arch] = {"warm_step_ms": sum(warm) / len(warm) * 1e3,
                            "first_step_ms": times[0] * 1e3, "losses": losses,
                            "tokens_per_s": B * S * len(warm) / sum(warm),
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  train {arch} B={B} S={S}: warm step {sum(warm) / len(warm) * 1e3:.2f} ms "
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
                "k2": steps * len(train_leaf_shapes(cfg)), "k3": 0, "k3b": 0}
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

    def record_routes():
        """Patch ``moe._top_k`` to record each call's (experts, router
        probabilities) as numpy; returns (the list, the undo)."""
        calls, top_k = [], moe._top_k

        def spy(probs, K):
            w, idx = top_k(probs, K)
            calls.append((idx.cpu().numpy(), probs.detach().float().cpu().numpy()))
            return w, idx

        moe._top_k = spy
        return calls, lambda: setattr(moe, "_top_k", top_k)

    def hold_routes(recorded, max_dp):
        """Patch ``moe._top_k`` to hold each call to the recorded call of the
        same shape whose probabilities lie nearest (|dp| <= ``max_dp``):
        the same ordered experts wherever its neighbouring probabilities
        among a token's k + 1 largest lie further apart than twice that |dp|
        (the order of the k choices sets their slots), and its experts taken
        where they differ (ROUTER_DP's comment).  Returns (a report, the
        undo)."""
        report, top_k = {"calls": 0, "forced": 0, "max_dp": 0.0}, moe._top_k

        def held(probs, K):
            w, idx = top_k(probs, K)
            p = probs.detach().float().cpu().numpy()
            dp, ri, rp = min(((float(abs(p - rp).max()), ri, rp) for ri, rp in recorded
                              if rp.shape == p.shape), key=lambda c: c[0])
            srt = -numpy.sort(-rp, -1)[..., :K + 1]   # neighbours among the k + 1 largest
            gap = (srt[..., :-1] - srt[..., 1:]).min(-1)
            differ = (idx.cpu().numpy() != ri).any(-1)
            assert dp <= max_dp, f"router probabilities {dp:.3e} apart"
            assert (gap[differ] <= 2 * dp).all(), "experts differ beyond the rounding"
            report["calls"] += 1
            report["forced"] += int(differ.sum())
            report["max_dp"] = max(report["max_dp"], dp)
            if differ.any():
                idx = torch.from_numpy(ri.copy()).to(idx.device, idx.dtype)
                w = torch.gather(probs, -1, idx)
            return w, idx

        moe._top_k = held
        return report, lambda: setattr(moe, "_top_k", top_k)

    def train_smoke(arch, leaves):
        """``arch``'s SMOKE config (minicpm3-4b: K1 and its backward at head
        dims 24 / 16; granite-20b: learned positions, 4 heads on one kv head
        of 16; qwen3-moe-30b-a3b and arctic-480b: MoE, their routes on the
        card held to the CPU route's first, ``hold_routes``; whisper-small:
        the encoder-decoder, on frames and decoder tokens; mamba2-780m: K3
        and its backward, no attention; hymba-1.5b: K1 and K3 side by side):
        the loss and every gradient (``leaves`` of them) on the card against
        the CPU route, from the same parameters and batch, in float32 and
        bfloat16; then one optimizer step on the card with int8-compressed
        gradients, and the launcher's loop.  Launches a step:
        ``train_launches``."""
        base = get_smoke(arch)
        batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
            base.vocab, 2, 32, seed=0, family=base.family, d_model=base.d_model).next().items()}
        cpu = torch.device("cpu")
        per_step = train_launches(base, ("k1",) * (base.family != "ssm")
                                  + ("k3",) * (base.family in ("ssm", "hybrid")))
        n_fwd, n_bwd = per_step["k1"], per_step["k1b"]

        def loss_and_grads(model, params, device):
            leaves = list(tree_leaves(params))
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = model.loss(params, {k: v.to(device) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
            return float(loss), [g.float().cpu() for g in grads]

        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype)
            model = build(cfg)
            np_params = params_to_numpy(model.init(torch.Generator(cpu).manual_seed(0)))
            routes, undo = record_routes()
            try:
                want_loss, want = loss_and_grads(model, params_from_numpy(np_params, cpu), cpu)
            finally:
                undo()
            report, undo = hold_routes(routes, ROUTER_DP[dtype])
            zero_counts()
            try:
                loss, got = loss_and_grads(model, params_from_numpy(np_params, dev), dev)
            finally:
                undo()
            counts = read_counts(f"train {arch} SMOKE {dtype}")
            if cfg.family == "moe":
                srt = numpy.concatenate([-numpy.sort(-p, -1).reshape(-1, p.shape[-1])
                                         for _, p in routes])
                gaps = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
                print(f"  {arch} SMOKE {dtype} routes: {len(routes)} CPU calls, smallest gap "
                      f"{float(gaps[gaps > 0].min()):.3e}, card {report}")
                assert report["calls"] == len(routes)
                assert dtype == "bfloat16" or report["forced"] == 0, report
            routes = dict(fa.flash_attention_cuda.routes), dict(fa.flash_attention_bwd_cuda.routes)
            route = fa.route(cfg.cdt, cfg.head_dim, cfg.v_head_dim or cfg.head_dim)
            loss_tol, grad_tol = STEP_TOL[dtype]
            if base.family in ("ssm", "hybrid"):
                grad_tol = SSM_GRAD_TOL[dtype]
            errs = [float(((g - w).abs() / (1 + w.abs())).max()) for g, w in zip(got, want)]
            err = max(errs)
            worst = [key for key, _ in flatten(params_from_numpy(np_params, cpu))][errs.index(err)]
            print(f"  {arch} SMOKE {dtype}: loss card {loss:.6f} cpu {want_loss:.6f} "
                  f"(tol {loss_tol}), {len(got)} gradients max |d|/(1+|ref|) {err:.3e} at "
                  f"{worst} (tol {grad_tol}), launches {counts}, K1 routes {routes[0]} / "
                  f"{routes[1]}")
            assert abs(loss - want_loss) <= loss_tol, (loss, want_loss)
            assert len(got) == len(want) == leaves and err <= grad_tol, err
            # K1 and K3 once a call in the forward and once in the remat
            # recompute (none in the encoder-decoder's), their backwards once
            assert counts == per_step, (counts, per_step)
            assert routes == tuple({**dict.fromkeys(fa.ROUTES, 0), route: n}
                                   for n in (n_fwd, n_bwd)), routes
        opt = AdamW(lr=1e-3)
        state = {"params": params_from_numpy(np_params, dev)}
        state["opt"] = opt.init(state["params"])
        zero_counts()
        metrics = tsteps.make_train_step(model, opt, compress=True)(
            state, {k: v.to(dev) for k, v in batch.items()})
        counts = read_counts(f"train {arch} SMOKE")
        want_counts = {**per_step, "k2": leaves}
        print(f"  one bf16 step on the card, compressed gradients: loss "
              f"{float(metrics['loss']):.6f}, launches {counts}")
        assert counts == want_counts, (counts, want_counts)
        assert math.isfinite(float(metrics["loss"]))
        # the launcher itself, with checkpoints through NVCacheFS
        steps = 6
        zero_counts()
        out = launch_train.main(["--arch", arch, "--smoke", "--steps", str(steps),
                                 "--ckpt-every", "5", "--compress-grads"])
        counts = read_counts(f"train loop {arch} SMOKE")
        want_counts = {key: steps * n for key, n in want_counts.items()}
        print(f"  launch.train --arch {arch} --smoke: {out['steps']} steps, loss "
              f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}, launches {counts}")
        assert counts == want_counts, (counts, want_counts)
        assert out["steps"] == steps and math.isfinite(out["last_loss"])

    train_runs = {}
    for arch in TRAIN_ARCHS:
        phase(f"train {arch}", lambda: train_full_width(arch))
    print(json.dumps({"train_runs": train_runs}))
    # embed, final_norm and the layers' 9 (the SSM's 8 and norm1); hymba adds
    # attention's 4, the MLP's 3, norm2, the two fuse weights and unembed
    phase("train mamba2-780m SMOKE", lambda: train_smoke("mamba2-780m", 11))
    phase("train hymba-1.5b SMOKE", lambda: train_smoke("hymba-1.5b", 22))
    phase("train minicpm3-4b SMOKE", lambda: train_smoke("minicpm3-4b", 14))
    # embed, unembed, final_norm, pos_table and the layers' 9 (GQA, MLP, norms)
    phase("train granite-20b SMOKE", lambda: train_smoke("granite-20b", 13))
    # embed, unembed, final_norm and the layers' 10: GQA, the router and
    # three expert tensors, the norms; arctic also its dense MLP's three
    phase("train qwen3-moe-30b-a3b SMOKE", lambda: train_smoke("qwen3-moe-30b-a3b", 13))
    phase("train arctic-480b SMOKE", lambda: train_smoke("arctic-480b", 16))
    # embed, dec_pos, the final LayerNorms' 4 and the layers' 12 (encoder:
    # two LayerNorms, GQA, the MLP with biases) and 18 (decoder: three
    # LayerNorms, self and cross GQA, the MLP)
    phase("train whisper-small SMOKE", lambda: train_smoke("whisper-small", 36))
    phase("train loop SMOKE", train_loop_smoke)

    # --------------------------------------------------------------- shapes
    def run_shape_cell(arch, shape_name, steps):
        """One cell of the JAX package's assigned shapes on the card, through
        configs/shapes.py and train/steps.py (``dryrun.card_record``): at the
        shape's batch or, when that runs out of memory, the largest power of
        two below it that runs; ``steps`` steps, exact launches a step, every
        K1 and K3 launch on its wgmma route, finite outputs."""
        cfg, full = get_config(arch), SHAPES[shape_name]
        batch = full.batch
        while True:
            shape = scale_shape(full, batch=batch)
            zero_counts()
            try:
                rec = dryrun.card_record(cfg, shape, reps=steps)
                break
            except torch.OutOfMemoryError:
                pass
            gc.collect()
            torch.cuda.empty_cache()
            if batch == 1:
                raise AssertionError(f"{arch} {shape_name} does not run at batch 1")
            print(f"  {arch} {shape_name}: batch {batch} runs out of the card's memory")
            batch //= 2
        counts = read_counts(f"{shape_name} {arch}")
        routes = {"k1": dict(fa.flash_attention_cuda.routes),
                  "k1b": dict(fa.flash_attention_bwd_cuda.routes),
                  "k3": dict(ssd.ssd_cuda.routes), "k3b": dict(ssd.ssd_bwd_cuda.routes)}
        own = ARCHS[arch] if full.kind != "decode" else ()   # decode attends in plain torch
        if full.kind == "train":
            per_step = train_launches(cfg, own)
        else:
            per_step = {"k1": k1_calls(cfg) if "k1" in own else 0, "k1b": 0, "k2": 0,
                        "k3": cfg.n_layers if "k3" in own else 0, "k3b": 0}
        want = {key: steps * n for key, n in per_step.items()}
        cells[(arch, shape_name)] = {"batch": batch, "full_batch": full.batch, "seq": full.seq,
                                     **{k: rec[k] for k in ("step_ms", "peak_bytes", "launches",
                                                            "resident_bytes", "cache_bytes",
                                                            "outputs")}}
        print(f"  shape cell {arch} {shape_name}: seq {full.seq}, batch {batch} of {full.batch}"
              f"{' (cut)' if batch < full.batch else ''}, {rec['outputs']}, {steps} steps "
              + ", ".join(f"{t:.2f}" for t in rec["step_ms"]) + " ms, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB (state, inputs, cache and outputs "
              f"{rec['resident_bytes'] / 2**30:.2f} GiB), launches {counts}, routes "
              f"{ {k: v for k, v in routes.items() if any(v.values())} }")
        assert counts == want, f"{arch} {shape_name}: launches {counts}, want {want}"
        for key in ("k1", "k1b", "k3", "k3b"):
            if want[key]:
                assert routes[key] == {**dict.fromkeys(routes[key], 0), "wgmma": want[key]}, (
                    key, routes[key])
        assert rec["finite"], f"{arch} {shape_name}: non-finite output"
        assert full.kind == "train" or rec["output_shape"] == (batch, 1, cfg.vocab), rec["outputs"]
        torch.cuda.empty_cache()

    def train_e2e_100m():
        """examples/torch_train_e2e.py --preset 100m on the card: K1 and its
        backward on the wgmma route, checkpoints through NVCache."""
        spec = importlib.util.spec_from_file_location(
            "torch_train_e2e", Path(__file__).resolve().parent / "examples" / "torch_train_e2e.py")
        e2e = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(e2e)
        zero_counts()
        out = e2e.main(["--preset", "100m", "--steps", str(E2E_STEPS),
                        "--ckpt-every", str(E2E_CKPT_EVERY)])
        counts = read_counts("torch_train_e2e 100m")
        n = E2E_STEPS * e2e.PRESETS["100m"]["n_layers"]
        want = {"k1": 2 * n, "k1b": n, "k2": 0, "k3": 0, "k3b": 0}
        warm = [h["step_time"] for h in out["history"][1:]]
        cells["e2e_100m"] = {"steps": out["steps"], "first_loss": out["first_loss"],
                             "last_loss": out["last_loss"], "mean_step_s": out["step_s"],
                             "warm_step_ms": sum(warm) / len(warm) * 1e3,
                             "first_step_ms": out["history"][0]["step_time"] * 1e3}
        print(f"  torch_train_e2e --preset 100m: {out['steps']} steps, loss "
              f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}, warm step "
              f"{cells['e2e_100m']['warm_step_ms']:.2f} ms (first "
              f"{cells['e2e_100m']['first_step_ms']:.2f}), launches {counts}, routes "
              f"{fa.flash_attention_cuda.routes} / {fa.flash_attention_bwd_cuda.routes}")
        assert counts == want, (counts, want)
        assert fa.flash_attention_cuda.routes["wgmma"] == want["k1"]
        assert fa.flash_attention_bwd_cuda.routes["wgmma"] == want["k1b"]
        assert out["steps"] == E2E_STEPS and out["last_loss"] < out["first_loss"]

    def checkpoint_bench():
        """launch/ckpt_bench.py from a CUDA state: save latency by stack,
        the restore copied back onto the card and held to the state."""
        rows = ckpt_bench.run(CKPT_MIB, device="cuda")
        cells["ckpt_bench"] = rows
        for r in rows:
            print(f"  ckpt_bench {r['stack']}: state {r['state_bytes'] / 2**20:.1f} MiB on the "
                  f"card, save {r['save_s']:.4f} s ({r['save_mib_s']:.1f} MiB/s), drain "
                  f"{r['drain_s']:.4f} s, {r['bytes'] / 2**20:.1f} MiB written, restore "
                  f"{'exact' if r['restore_ok'] else 'MISMATCH'}")
        assert [r["stack"] for r in rows] == ["blob-sync", "nvcache", "page-cache-unsafe",
                                              "nvcache+int8"]
        assert all(r["restore_ok"] for r in rows), rows

    cells = {}
    for arch, shape_name, steps in SHAPE_CELLS:
        phase(f"shapes {arch} {shape_name}",
              lambda: run_shape_cell(arch, shape_name, steps))
    phase("shapes torch_train_e2e 100m", train_e2e_100m)
    phase("shapes ckpt_bench", checkpoint_bench)
    print(json.dumps({"shape_cells": {" ".join(k) if isinstance(k, tuple) else k: v
                                      for k, v in cells.items()}}))

    # ----------------------------------------------------------------- mesh
    # this slice's main path: the port's distribution layer (launch/mesh.py,
    # parallel/, train/steps.py's shardings), each kernel on its rank's shard
    # through kernels/ops.py's local_map; the kernels line's launches are
    # these runs'
    def mesh_single():
        # mesh_check reads each sharded run from counts set to 0 just before
        # it (the unsharded runs it is held against are not counted): those
        # counts are this path's
        torch.cuda.empty_cache()
        zero_counts()
        res = mesh_check.single_mesh()
        print(json.dumps({"mesh_single": res}))
        print(f"  1x1 mesh ({res['backend']}), llama3.2-1b 4 x 2048: loss {res['loss_sharded']:.6f} "
              f"sharded, {res['loss_unsharded']:.6f} unsharded (|d| {res['loss_diff']:.3e}), "
              f"parameters max |d| {res['param_max_diff']:.3e} (unsharded run to run "
              f"{res['rerun_param_max_diff']:.3e}), gradients worst leaf |d|/max|m| "
              f"{res['grad_worst_rel']:.3e} (run to run {res['rerun_grad_worst_rel']:.3e}, "
              f"limit {mesh_check.GRAD_TOL:.3e}); warm step "
              f"{res['warm_mean_ms']['sharded']:.2f} ms sharded, "
              f"{res['warm_mean_ms']['unsharded']:.2f} ms unsharded (DTensor's dispatch "
              f"{res['dispatch_overhead_ms']:+.2f} ms); launches a step {res['launches_sharded']}; "
              f"serve logits within {res['serve_worst_rel']:.3e}·(1+|ref|), "
              f"launches {res['serve_launches']}")
        assert not res["failed"], res["failed"]
        for key, (entry, _) in kernels.items():
            for path, counts in (("mesh 1x1 llama3.2-1b train step", res["launches_sharded"]),
                                 ("mesh 1x1 llama3.2-1b serve", res["serve_launches"])):
                if counts.get(key):   # mesh_check counts K1, its backward, K2 and K3
                    entry["paths"][path] = counts[key]
        for key in ("k1", "k1b"):   # a sharded step's; K2's and K3's: mamba2's below
            kernels[key][0]["launches"] = res["launches_sharded"][key]
        torch.cuda.empty_cache()
        zero_counts()
        res = mesh_check.ssm_serve()
        print(json.dumps({"mesh_ssm": res}))
        assert not res["failed"], res["failed"]
        kernels["k3"][0]["paths"]["mesh 1x1 mamba2-780m serve"] = res["serve_launches"]["k3"]

    def mesh_ssm_train():
        # phase 5's mamba2-780m step on the 1x1 mesh: K3 and its backward on
        # the rank's heads through ops.ssd's local_map.  A size-1 axis's
        # partial sum is already whole, so the summed dA, dB and dC show on
        # the CPU's four gloo ranks (tests/test_torch_mesh_ssm.py), not here;
        # nor can four ranks on this one card run the step: gloo aborts on
        # DTensor's redistributes of CUDA tensors, and NCCL refuses two ranks
        # on one device (launch/mesh_check.py)
        torch.cuda.empty_cache()
        zero_counts()
        res = mesh_check.single_mesh(get_config("mamba2-780m"))
        print(json.dumps({"mesh_ssm_train": res}))
        print(f"  1x1 mesh ({res['backend']}), mamba2-780m 4 x 2048: loss "
              f"{res['loss_sharded']:.6f} sharded, {res['loss_unsharded']:.6f} unsharded "
              f"(|d| {res['loss_diff']:.3e}), parameters max |d| {res['param_max_diff']:.3e} "
              f"(unsharded run to run {res['rerun_param_max_diff']:.3e}), gradients worst leaf "
              f"|d|/max|m| {res['grad_worst_rel']:.3e} (run to run "
              f"{res['rerun_grad_worst_rel']:.3e}, limit {res['grad_tol']:.3e}: twice that); "
              f"by leaf {res['grad_rel']} (run to run {res['rerun_grad_rel']}); warm step "
              f"{res['warm_mean_ms']['sharded']:.2f} ms sharded, "
              f"{res['warm_mean_ms']['unsharded']:.2f} ms unsharded (DTensor's dispatch "
              f"{res['dispatch_overhead_ms']:+.2f} ms); peak memory "
              f"{res['peak_gib_sharded']:.2f} GiB; launches a step {res['launches_sharded']} "
              f"(wanted {res['launches_wanted']}), K3 routes {res['k3_routes']}, K3 backward "
              f"routes {res['k3b_routes']}")
        assert not res["failed"], res["failed"]
        for key in ("k2", "k3", "k3b"):
            kernels[key][0]["paths"]["mesh 1x1 mamba2-780m train step"] = \
                res["launches_sharded"][key]
            kernels[key][0]["launches"] = res["launches_sharded"][key]

    def mesh_gloo():
        # four ranks on the one card run only what needs none of the ops
        # gloo refuses on CUDA tensors (send/recv, the functional all-gather
        # under every DTensor redistribute: PERF.md §6), so the sharded
        # model steps run on the CPU's gloo only (tests/test_torch_mesh.py)
        for name, part in (("compressed_psum", mesh_check.ranks_psum),
                           ("pipeline", mesh_check.ranks_pipeline)):
            res = part()
            print(json.dumps({f"gloo 4 ranks {name}": res}))
            assert not res["failed"], res["failed"]
            if name == "compressed_psum":
                kernels["k2"][0]["paths"]["mesh 4 gloo ranks compressed_psum"] = sum(
                    n for rk in res["ranks"] for key, n in rk.items()
                    if key.startswith("k2_launches"))

    phase("mesh 1x1", mesh_single)
    phase("mesh 1x1 mamba2-780m train", mesh_ssm_train)
    phase("mesh gloo on CUDA", mesh_gloo)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()

    # -------------------------------------------------------------- tooling
    # the mesh tooling on this host's torch: the dry run's mesh mode in fake
    # worlds of 256 and 512 ranks (meta only), the roofline of phase 6's card
    # runs, and the perf probe.  No kernel is launched here: the kernels' work
    # in the roofline is what phase 6's runs launched (K1, its backward, K3)
    def tooling_mesh():
        for kind, cells_ in TOOLING_MESH_CELLS.items():
            for rec in dryrun.run_cells(kind, cells_, device="cpu"):
                tag = f"{rec['arch']} {rec['shape']} {kind}"
                assert rec["status"] == "ok", (tag, rec.get("error"))
                tooling["mesh"][tag] = {k: rec[k] for k in TOOLING_KEYS}
                print(f"  mesh mode {tag}: {rec['devices']} devices, counted in "
                      f"{rec['counted_s']:.2f} s; per device state {rec['state_bytes']}, inputs "
                      f"{rec['input_bytes']}, cache {rec['cache_bytes']}, outputs "
                      f"{rec['output_bytes']}, resident {rec['resident_bytes']} B "
                      f"(fits one card: {rec['fits_one_card']}); flops {rec['flops']} "
                      f"{rec['flops_by_dtype']}, work_flops {rec['work_flops']}, hbm "
                      f"{rec['hbm_bytes']}, work_hbm {rec['work_hbm_bytes']} B; collectives "
                      f"{rec['collectives']}, wire {rec['wire_bytes']} B")

    def tooling_roofline():
        """Each phase 6 cell's count at its full batch and at its cut: the
        cut's bound (the larger of its compute and memory terms) must be at
        or below its fastest measured step."""
        for (arch, shape_name), cell in ((k, v) for k, v in cells.items()
                                         if isinstance(k, tuple)):
            full = SHAPES[shape_name]
            for batch in dict.fromkeys((full.batch, cell["batch"])):
                count = dryrun.counted_record(get_config(arch), scale_shape(full, batch=batch))
                t = roofline.terms(count)
                line = (f"  roofline {arch} {shape_name} batch {batch}: t_compute "
                        f"{t['t_compute']:.6f} s, t_memory {t['t_memory']:.6f} s (work_flops "
                        f"{count['work_flops']}, work_hbm {count['work_hbm_bytes']} B)")
                if batch == cell["batch"]:
                    bound, measured = roofline.bound_s(count), min(cell["step_ms"]) / 1e3
                    tooling["roofline"][f"{arch} {shape_name}"] = {
                        "batch": batch, **t, "bound_s": bound, "measured_s": measured,
                        "roofline_fraction_measured": bound / measured}
                    line += (f"; measured {measured:.6f} s, roofline_fraction_measured "
                             f"{bound / measured:.4f}")
                    assert bound <= measured, (arch, shape_name, bound, measured)
                print(line)

    def tooling_probe():
        rec = perf_probe.probe("llama3.2-1b", "train_4k", remat="none")
        tooling["perf_probe"] = {k: rec[k] for k in ("t_compute", "t_memory", "t_collective",
                                                     "work_flops")}

    tooling = {"mesh": {}, "roofline": {}}
    t_tooling = time.perf_counter()
    phase("tooling mesh mode", tooling_mesh)
    phase("tooling roofline", tooling_roofline)
    phase("tooling perf_probe", tooling_probe)
    tooling["seconds"] = time.perf_counter() - t_tooling
    print(json.dumps({"tooling": tooling}))

    # --------------------------------------------------------------- engine
    # this slice's path: the NVCache engine's remaining modules (kvlite, the
    # legacy stores, the flight dump, the lint), driven as a user runs them.
    # Host code in processes of its own: the counts, set to 0 before, stay 0
    def engine_path():
        zero_counts()
        engine.update(run_engine(Path(__file__).resolve().parent))
        assert not any(read_counts("engine").values())

    engine = {}
    t_engine = time.perf_counter()
    phase("engine", engine_path)
    engine["phase_seconds"] = time.perf_counter() - t_engine
    print(json.dumps({"engine": engine}))

    print(json.dumps({"kernels": [k1, k1b, k2, k3, k3b]}))
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
