#!/usr/bin/env python3
"""Chip check of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. build   every kernel of the serving path from ``src/repro_torch/csrc``;
  2. kernels each kernel against its plain PyTorch version on the card, on
             the sweep of the CPU tests and at every shape phases 3 and 4
             drive it at, with its time at the serving prefill shape beside
             the plain version's, a library call's and the card's bound;
  3. serve   llama3.2-1b at full width (batch 4, prompt 2048, 32 new tokens)
             through ``repro_torch.launch.serve.main``, with the kernels'
             launch counts read around that one run and the request log read
             back through the port's NVCacheFS;
  4. decode  teacher-forced decode against the full-sequence forward at full
             width, in float32 and in bfloat16.
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
from pathlib import Path

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
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
DECODE_TOL = {"float32": 2e-3, "bfloat16": 0.25}   # max |logit| gap, 64 tokens, 16 layers


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
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
        lib = fa.build()
        print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
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

    phase("kernels", check_kernels)

    # ---------------------------------------------------------------- serve
    cfg = get_config("llama3.2-1b")

    def serve_full_width():
        B, P, T = 4, 2048, 32
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention_cuda.launches = 0
        res = serve.main(["--arch", "llama3.2-1b", "--batch", str(B), "--prompt-len", str(P),
                          "--tokens", str(T), "--seed", "0"])
        k1["launches"] = fa.flash_attention_cuda.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  serve: prefill {res.prefill_s * 1e3:.2f} ms, decode "
              f"{B * T / res.decode_s:.1f} tokens/s ({res.decode_s / T * 1e3:.2f} ms/step), "
              f"peak memory {peak:.2f} GiB, K1 launches {k1['launches']}")
        assert k1["launches"] == cfg.n_layers, \
            f"K1 launched {k1['launches']} times in prefill, want {cfg.n_layers}"
        assert res.tokens.shape == (B, T) and bool(torch.isfinite(res.logits).all())
        assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab
        lines = [json.loads(x) for x in res.log.decode().splitlines()]
        assert lines == [{"batch": B, "prompt_len": P},
                         {"completed": B * T, "seconds": lines[1]["seconds"]}], lines
        print(f"  request log read back: {lines}")

    phase("serve", serve_full_width)

    # --------------------------------------------------------------- decode
    def decode_matches_forward():
        S = 64
        for dtype in ("float32", "bfloat16"):
            model = build(dataclasses.replace(cfg, compute_dtype=dtype))
            gen = torch.Generator(dev).manual_seed(1)
            with torch.inference_mode():
                params = model.init(gen)
                toks = torch.randint(1, cfg.vocab - 1, (1, S), generator=gen, device=dev,
                                     dtype=torch.int32)
                full, _ = model.forward(params, {"tokens": toks})
                _, cache = model.prefill(params, {"tokens": toks[:, :1]}, S + 2)
                outs = []
                for t in range(1, S):
                    lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
                    outs.append(lg[:, 0])
                dec = torch.stack(outs, 1)
            assert bool(torch.isfinite(dec).all())
            gap = float((dec - full[:, 1:S]).abs().max())
            scale = float(full.abs().max())
            print(f"  decode vs forward, {dtype}: max |logit gap| {gap:.4e} "
                  f"(max |logit| {scale:.3f}), tol {DECODE_TOL[dtype]}")
            assert gap < DECODE_TOL[dtype], f"{dtype}: decode/forward gap {gap}"
            del params, cache

    phase("decode", decode_matches_forward)

    print(json.dumps({"kernels": [k1]}))
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
