"""Time K1 (flash attention, forward and backward) of this tree against
variants of its sources, in turns, on one card.

    python -m repro_torch.launch.bench_attention [DIR ...]

Each DIR holds a variant of ``csrc/flash_attention.cu`` and/or
``csrc/flash_attention_bwd.cu``, with the ``hopper.cuh`` it includes (put
it under ``build/``, which git ignores).  Every source is built with
``nvcc`` in parallel; each variant's forward is checked against
``attention_ref`` (|d| <= 2e-2·(1+|ref|)); then, at llama3.2-1b's
attention (B=4, S=2048, H=32, KV=8, D=64), at D=128 (B=2, S=2048, H=16,
KV=4) and at minicpm3-4b's MLA prefill (B=4, S=2048, H=KV=40, D=96,
Dv=64), bf16, causal, each forward and each backward is timed with
CUDA events (mean of 20 calls) in the order a, b, ..., ..., b, a beside
``scaled_dot_product_attention`` (forward) or its backward.  Prints the
card's name and power limit, then one JSON line per shape and direction.
A variant that drops work gives wrong numbers but a time: that is how
the cost of a piece is found.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

SHAPES = [(4, 2048, 32, 8, 64, 64), (2, 2048, 16, 4, 128, 128), (4, 2048, 40, 40, 96, 64)]


def cuda_ms(fn, reps=20, warmup=2):
    """Mean device time (ms) of ``fn`` over ``reps`` back-to-back calls."""
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


def in_turns(fns, reps=20):
    """{name: [first, second]} mean ms of each named function, timed in the
    order a, b, ..., ..., b, a."""
    times = {name: [] for name, _ in fns}
    for name, fn in fns + fns[::-1]:
        times[name].append(cuda_ms(fn, reps))
    return times


def _with(name, entry, call):
    def run():
        saved = getattr(fa, name)
        setattr(fa, name, lambda: entry)
        try:
            return call()
        finally:
            setattr(fa, name, saved)
    return run


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA card")
    dirs = [Path(d) for d in (sys.argv[1:] if argv is None else argv)]
    srcs = [("tree", "fwd", fa.SRC), ("tree", "bwd", fa.BWD_SRC)]
    srcs += [(d.name, kind, d / src.name) for d in dirs
             for kind, src in (("fwd", fa.SRC), ("bwd", fa.BWD_SRC)) if (d / src.name).exists()]
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda s: _build.build(s[2]), srcs))
    entries = {"fwd": {}, "bwd": {}}
    for (name, kind, _), lib in zip(srcs, libs):
        entries[kind][name] = (fa.load_fwd if kind == "fwd" else fa.load_bwd)(lib)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for B, S, H, KV, D, Dv in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                       for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, Dv), (B, S, H, Dv)))
        want = ref.attention_ref(q, k, v, causal=True).float()
        fwd = {}
        for name, entry in entries["fwd"].items():
            fwd[name] = _with("_entry", entry, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
            diff = (fwd[name]().float() - want).abs()
            ok = bool((diff <= 2e-2 * (1 + want.abs())).all())
            print(f"  {name} forward at {(B, S, H, KV, D, Dv)}: max abs error {float(diff.max()):.3e} "
                  f"{'ok' if ok else 'MISMATCH'}")
        G = H // KV
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach().requires_grad_()
                  for t in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        with torch.no_grad():
            times = in_turns(list(fwd.items()) + [("sdpa", sdpa)])
        print(json.dumps({"shape": [B, S, H, KV, D, Dv], "direction": "forward", "ms": times}))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        bwd = [(name, _with("_bwd_entry", entry, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=True))) for name, entry in entries["bwd"].items()]
        out, dot = sdpa(), do.transpose(1, 2)
        bwd.append(("sdpa backward",
                    lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)))
        print(json.dumps({"shape": [B, S, H, KV, D, Dv], "direction": "backward",
                          "ms": in_turns(bwd)}), flush=True)


if __name__ == "__main__":
    main()
