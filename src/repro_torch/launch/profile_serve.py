"""Where the serving time goes on the card, warm.

    python -m repro_torch.launch.profile_serve

Serves each ported arch in turn, llama3.2-1b then mamba2-780m, at full
width (batch 4, prompt 2048, 32 new tokens, seed 0) with
``repro_torch.launch.serve``'s prefill and decode: one run to warm up
(allocator, cuBLAS, kernel library), one timed on the host clock around
synchronised work, and one under ``torch.profiler`` for the device time by
kernel.  For each it prints the warm prefill time, the decode time per
step, the device-busy share of each (device kernel time over the timed
run's wall time), the kernels that take the most device time, the
hand-written kernels' launches per prefill and, summed over the CUDA
kernels each of them runs (``OWN``), their device time per prefill and
share of the prefill's device time, then one JSON line with those numbers
and the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda
from repro_torch.launch.serve import decode, prefill
from repro_torch.models.registry import build

ARCHS = ("llama3.2-1b", "mamba2-780m")
B, P, T, SEED = 4, 2048, 32, 0   # the slices' serving shape
KERNELS = {"k1": flash_attention_cuda, "k3": ssd_cuda}
# device-kernel names of the hand-written kernels (substrings of the profiler's keys)
OWN = {"k1": ("fa_fwd_",), "k3": ("ssd_fwd", "ssd_chunk_state", "ssd_carry", "ssd_chunk_out")}
TOP = 12                         # kernels listed per phase


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_ms(prof):
    """Device time (ms) by kernel name, largest first.  Operator rows (on
    the CPU) are left out: their device time is that of the kernels they
    launched, which are rows of their own."""
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def profile_arch(arch: str, card: str):
    """Warm prefill and decode of ``arch`` at the serving shape; prints the
    breakdown and returns it as a dict."""
    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(SEED)
    result = {"arch": cfg.arch, "batch": B, "prompt_len": P, "tokens": T}
    with torch.inference_mode():
        params = model.init(gen)
        prompts = torch.randint(1, cfg.vocab - 1, (B, P), generator=gen, device=dev,
                                dtype=torch.int32)
        logits, cache = prefill(model, params, prompts, T)            # warm-up
        decode(model, params, logits, cache, T)
        (logits, cache), prefill_s = _timed(lambda: prefill(model, params, prompts, T))
        _, decode_s = _timed(lambda: decode(model, params, logits, cache, T))
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_p:
            logits, cache = prefill(model, params, prompts, T)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
            decode(model, params, logits, cache, T)
            torch.cuda.synchronize()
        for k, fn in KERNELS.items():
            result[f"{k}_launches_per_prefill"] = fn.launches - launches[k]

    for name, prof, wall_s, steps in (("prefill", prof_p, prefill_s, 1),
                                      ("decode", prof_d, decode_s, T)):
        rows = _device_ms(prof)
        dev_ms = sum(ms for _, ms in rows)
        result[f"{name}_ms"] = wall_s * 1e3 / steps
        result[f"{name}_device_ms"] = dev_ms / steps
        result[f"{name}_device_busy"] = dev_ms / (wall_s * 1e3)
        print(f"{arch} {name}: {wall_s * 1e3 / steps:.3f} ms{' per step' if steps > 1 else ''} "
              f"warm, device kernels {dev_ms / steps:.3f} ms, busy "
              f"{dev_ms / (wall_s * 1e3):.1%} of the unprofiled wall time")
        for key, ms in rows[:TOP]:
            print(f"  {ms / steps:9.3f} ms  {ms / dev_ms:6.1%}  {key[:100]}")
        result[f"{name}_top"] = [[key[:100], ms / steps] for key, ms in rows[:TOP]]
        if name == "prefill":
            for k, names in OWN.items():
                ms = sum(v for key, v in rows if any(n in key for n in names))
                result[f"{k}_ms_per_prefill"] = ms
                result[f"{k}_share_of_prefill"] = ms / dev_ms
                if ms:
                    print(f"  {k}: {ms:.3f} ms per prefill over its CUDA kernels, "
                          f"{ms / dev_ms:.1%} of the prefill's device time")
    result["decode_tokens_per_s"] = B * T / decode_s
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["card"] = card
    print(json.dumps(result), flush=True)
    return result


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [profile_arch(arch, smi.stdout.strip()) for arch in ARCHS]


if __name__ == "__main__":
    main()
