"""Training launcher: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 50

Wires: config -> model -> AdamW -> deterministic data pipeline -> NVCache
(fast persistent tier in front of the blob tier) -> train loop with
synchronous-durability checkpoints, metrics JSONL and crash-safe resume.
Runs on the CUDA device unless ``--device cpu`` is given.  ``--mesh
debug`` trains on ``make_debug_mesh()``'s 2x2 ("data", "model") mesh over a
job of four processes:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh debug --smoke

(``nccl`` on ``cuda``, ``gloo`` with ``--device cpu``); rank 0 checkpoints
and prints the summary.
"""
from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.core import NVCache, Policy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import init_distributed, make_debug_mesh
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import BLOB, Tier
from repro_torch.train import loop as train_loop


def main(argv=None) -> dict:
    """Runs the loop; prints and returns the summary (arch, steps, first and
    last loss, NVCache stats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=all_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="none", choices=["none", "debug"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-mib", type=float, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    opt = AdamW(lr=args.lr, schedule=warmup_cosine(10, args.steps))
    pipe = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=0,
                           family=cfg.family, d_model=cfg.d_model)

    policy = Policy(entry_size=16384,
                    log_entries=max(64, int(args.log_mib * (1 << 20) // 16384)),
                    read_cache_pages=256, batch_min=16, batch_max=1024,
                    verify_crc=False)
    tier = Tier(BLOB)                      # the slow/blob tier
    nv = NVCache(policy, tier)
    mesh = None
    try:
        if args.mesh == "debug":
            init_distributed(device_type=args.device)
            mesh = make_debug_mesh(device_type=args.device)
        fs = NVCacheFS(nv)
        _state, hist = train_loop.train(
            model, opt, pipe, fs, total_steps=args.steps,
            ckpt_every=args.ckpt_every, mesh=mesh, compress_grads=args.compress_grads,
            device=args.device)
        nv.flush()
        summary = {
            "arch": cfg.arch, "steps": len(hist),
            "first_loss": hist[0]["loss"] if hist else None,
            "last_loss": hist[-1]["loss"] if hist else None,
            "nvcache": nv.stats(),
        }
        if mesh is None or dist.get_rank() == 0:
            print(json.dumps(summary, indent=1))
    finally:
        nv.shutdown()
        if mesh is not None:
            dist.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
