#!/usr/bin/env python3
"""Chip check of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   every kernel of the serving paths from ``src/repro_torch/csrc``,
             one ``nvcc`` per source, all started together;
  2. kernels each kernel (K1 flash attention, K3 SSD scan) against its plain
             PyTorch version on the card, on the sweep of the CPU tests and
             at every shape phases 3 and 4 drive it at, with its time at the
             serving prefill shape beside the plain version's, a library
             call's (where one PyTorch call computes the same) and the
             card's bound;
  3. serve   llama3.2-1b, then mamba2-780m, at full width (batch 4, prompt
             2048, 32 new tokens) through ``repro_torch.launch.serve.main``,
             with the kernels' launch counts set to 0 just before and read
             just after each run, and the request log read back through the
             port's NVCacheFS;
  4. decode  teacher-forced decode against the full-sequence forward at full
             width, for each model, in float32 and in bfloat16.
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when there is no CUDA card or a phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
ARCHS = {"llama3.2-1b": "k1", "mamba2-780m": "k3"}   # each model's kernel
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


def attention_bound(B, Sq, Skv, H, KV, D, itemsize, causal, window, peak_flops):
    """Least time (ms) for one attention call: the larger of the operations
    the visible (query, key) pairs need over the peak rate and the bytes of
    q, k, v read once and o written once over the memory rate."""
    pairs = 0
    for i in range(Sq):
        hi = min(Skv, i + 1) if causal else Skv
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    flops = 4 * B * H * D * pairs
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:74", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}
    k3 = {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
          "replaces": "src/repro/kernels/ssd_scan.py:68", "launches": 0,
          "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
          "bound_by": None, "library_ms": None}   # no single PyTorch call scans SSD
    kernels = {"k1": (k1, fa.flash_attention_cuda), "k3": (k3, ssd.ssd_cuda)}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as exc:   # report every phase, fail at the end
            traceback.print_exc()
            failures.append(f"{name}: {exc!r}")
            print(f"[{name}] FAILED: {exc!r}", flush=True)

    # ---------------------------------------------------------------- build
    def build_kernels():
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc per source, together
            libs = list(pool.map(lambda mod: mod.build(), (fa, ssd)))
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
        for case in SWEEP + MODEL_CASES:
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
        k1["ms"] = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True), 20)
        k1["plain_ms"] = cuda_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True), 5)
        G = SLICE["H"] // SLICE["KV"]
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        k1["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), 20)
        k1["bound_ms"], k1["bound_by"] = attention_bound(
            *SLICE.values(), 2, True, 0, PEAK_BF16_FLOPS)
        print(f"  K1 at {SLICE} bf16 causal: kernel {k1['ms']:.4f} ms, plain "
              f"{k1['plain_ms']:.4f} ms, sdpa {k1['library_ms']:.4f} ms, bound "
              f"{k1['bound_ms']:.4f} ms ({k1['bound_by']})")
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

    phase("kernels K1", check_kernels)
    phase("kernels K3", check_ssd)

    # ---------------------------------------------------------------- serve
    def serve_full_width(arch):
        cfg = get_config(arch)
        B, P, T = 4, 2048, 32
        torch.cuda.reset_peak_memory_stats()
        for _, fn in kernels.values():
            fn.launches = 0
        res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                          "--tokens", str(T), "--seed", "0"])
        counts = {key: fn.launches for key, (_, fn) in kernels.items()}
        own = ARCHS[arch]
        kernels[own][0]["launches"] = counts[own]
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

    print(json.dumps({"kernels": [k1, k3]}))
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
