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
time, the device time of each of the step's phases (the device work
launched inside the ranges ``train.forward``, ``train.backward``,
``train.compress`` and ``train.optimizer`` of ``train/steps.py``), the
hand-written kernels' launches and device time per step (the device work
launched inside each kernel's range, ``runtime/ranges.py``), and the peak
memory, then one JSON line with those numbers and the card's name and
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.profile_serve import TOP, _device_ms, _span_ms
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.train import steps as tsteps

ARCHS = ("llama3.2-1b", "mamba2-780m", "hymba-1.5b")   # chip_smoke.py's TRAIN_ARCHS
B, S, SEED = 4, 2048, 0                        # the training slice's shape
LR = 1e-5                                      # chip_smoke.py's TRAIN_LR
# each hand-written kernel's wrapper (it counts the launches) and range
KERNELS = {"k1": (fa.flash_attention_cuda, fa.FWD_SPAN),
           "k1b": (fa.flash_attention_bwd_cuda, fa.BWD_SPAN),
           "k2": (qz.quantize_cuda, qz.SPAN),
           "k3": (ssd.ssd_cuda, ssd.FWD_SPAN), "k3b": (ssd.ssd_bwd_cuda, ssd.BWD_SPAN)}
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
    launches = {k: fn.launches for k, (fn, _) in KERNELS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = {k: fn.launches - launches[k] for k, (fn, _) in KERNELS.items()}

    rows = _device_ms(prof)
    dev_ms = sum(ms for _, ms in rows)
    own = {k: _span_ms(prof, rng) for k, (_, rng) in KERNELS.items()}
    phases = {rng: _span_ms(prof, rng) for rng in tsteps.PHASES}
    result = {"arch": cfg.arch, "batch": B, "seq": S, "remat": cfg.remat,
              "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
              "device_ms": dev_ms, "device_busy": dev_ms / (step_s * 1e3),
              "phase_ms_per_step": phases,
              "launches_per_step": launches, "kernel_ms_per_step": own,
              "losses": losses, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
              "top": [[key[:100], ms] for key, ms in rows[:TOP]],
              "card": smi.stdout.strip()}
    print(f"{cfg.arch} train step (B={B}, S={S}, remat {cfg.remat}): {step_s * 1e3:.2f} ms warm, "
          f"{B * S / step_s:.1f} tokens/s, device kernels {dev_ms:.2f} ms, busy "
          f"{dev_ms / (step_s * 1e3):.1%} of the unprofiled wall time, peak memory "
          f"{result['peak_memory_gib']:.2f} GiB")
    print("  device ms per step by phase: "
          + ", ".join(f"{rng} {ms:.3f} ({ms / dev_ms:.1%})" for rng, ms in phases.items()))
    print(f"  hand-written kernels per step: launches {launches}, device ms "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in own.items()))
    for key, ms in rows[:TOP]:
        print(f"  {ms:9.3f} ms  {ms / dev_ms:6.1%}  {key[:100]}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
