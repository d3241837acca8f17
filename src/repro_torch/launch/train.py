"""Training launcher: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 50

Wires: config -> model -> AdamW -> deterministic data pipeline -> NVCache
(fast persistent tier in front of the blob tier) -> train loop with
synchronous-durability checkpoints, metrics JSONL and crash-safe resume.
Runs on the CUDA device unless ``--device cpu`` is given.  The JAX
launcher's ``--mesh`` comes with the distribution slice.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.core import NVCache, Policy
from repro_torch.data.pipeline import SyntheticTokens
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
    try:
        fs = NVCacheFS(nv)
        _state, hist = train_loop.train(
            model, opt, pipe, fs, total_steps=args.steps,
            ckpt_every=args.ckpt_every, compress_grads=args.compress_grads,
            device=args.device)
        nv.flush()
        summary = {
            "arch": cfg.arch, "steps": len(hist),
            "first_loss": hist[0]["loss"] if hist else None,
            "last_loss": hist[-1]["loss"] if hist else None,
            "nvcache": nv.stats(),
        }
        print(json.dumps(summary, indent=1))
    finally:
        nv.shutdown()
    return summary


if __name__ == "__main__":
    main()
