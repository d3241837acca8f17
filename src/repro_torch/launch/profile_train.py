"""Where the training step's time goes on the card, warm.

    python -m repro_torch.launch.profile_train [--arch llama3.2-1b | mamba2-780m | hymba-1.5b]

Trains one model at full width (llama3.2-1b by default; mamba2-780m runs K3
and its backward in every layer, hymba-1.5b K1, K3 and both backwards;
batch 4 x 2048 tokens, bf16 compute, f32 parameters, remat "dots", AdamW,
int8-compressed gradients) through
``repro_torch.train.steps``: two steps to warm up (allocator, cuBLAS, the
kernels' builds), three timed on the host clock around synchronised work,
and one under ``torch.profiler`` for the device time by kernel.  Prints the
warm step time, tokens/s, the device-busy share (device kernel time over
the timed steps' mean wall time), the kernels that take the most device
time, the hand-written kernels' launches and device time per step, and the
peak memory, then one JSON line with those numbers and the card's name and
power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.ssd_scan import ssd_bwd_cuda, ssd_cuda
from repro_torch.launch.profile_serve import TOP, _device_ms
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.train import steps as tsteps

ARCHS = ("llama3.2-1b", "mamba2-780m", "hymba-1.5b")   # chip_smoke.py's TRAIN_ARCHS
B, S, SEED = 4, 2048, 0                        # the training slice's shape
LR = 1e-5                                      # chip_smoke.py's TRAIN_LR
KERNELS = {"k1": flash_attention_cuda, "k1b": flash_attention_bwd_cuda, "k2": quantize_cuda,
           "k3": ssd_cuda, "k3b": ssd_bwd_cuda}
# device-kernel names of the hand-written kernels (substrings of the profiler's keys)
OWN = {"k1": ("fa_fwd_",), "k1b": ("bwd_delta", "bwd_dq_", "bwd_dkdv_", "bwd_wgmma"),
       "k2": ("quantize_kernel",),
       "k3": ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd"),
       # the backward's two routes: wgmma (state, split_carry, tiles, dc), fma
       # (states, carry, chunk), and the bf16 casts of both
       "k3b": ("ssd_bwd_state", "ssd_bwd_split_carry", "ssd_bwd_tiles", "ssd_bwd_dc",
               "ssd_bwd_carry", "ssd_bwd_chunk", "cast_rows")}
WARM, TIMED = 2, 3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    model, opt = build(cfg), AdamW(lr=LR)
    torch.cuda.reset_peak_memory_stats()
    state = tsteps.init_train_state(model, opt, torch.Generator(dev).manual_seed(SEED))
    step = tsteps.make_train_step(model, opt, compress=True)
    pipe = SyntheticTokens(cfg.vocab, B, S, seed=SEED)

    def run():
        batch = {"tokens": torch.from_numpy(pipe.next()["tokens"]).to(dev)}
        return float(step(state, batch)["loss"])

    for _ in range(WARM):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [run() for _ in range(TIMED)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = {k: fn.launches - launches[k] for k, fn in KERNELS.items()}

    rows = _device_ms(prof)
    dev_ms = sum(ms for _, ms in rows)
    own = {k: sum(ms for key, ms in rows if any(n in key for n in names))
           for k, names in OWN.items()}
    result = {"arch": cfg.arch, "batch": B, "seq": S, "remat": cfg.remat,
              "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
              "device_ms": dev_ms, "device_busy": dev_ms / (step_s * 1e3),
              "launches_per_step": launches, "kernel_ms_per_step": own,
              "losses": losses, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "top": [[key[:100], ms] for key, ms in rows[:TOP]],
              "card": smi.stdout.strip()}
    print(f"{cfg.arch} train step (B={B}, S={S}, remat {cfg.remat}): {step_s * 1e3:.2f} ms warm, "
          f"{B * S / step_s:.1f} tokens/s, device kernels {dev_ms:.2f} ms, busy "
          f"{dev_ms / (step_s * 1e3):.1%} of the unprofiled wall time, peak memory "
          f"{result['peak_memory_gib']:.2f} GiB")
    print(f"  hand-written kernels per step: launches {launches}, device ms "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in own.items()))
    for key, ms in rows[:TOP]:
        print(f"  {ms:9.3f} ms  {ms / dev_ms:6.1%}  {key[:100]}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
