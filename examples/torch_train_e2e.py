"""End-to-end training on the PyTorch port.

Presets (those of ``examples/train_e2e.py``):
  tiny   ~0.1M params,  fast CPU demo (default here)
  small  ~10M params,   minutes on CPU
  100m   ~100M params,  the deliverable scale: 12 layers, d_model 768, head
                        dim 64, 8 x 512 tokens (on the card, bf16 attention
                        on the hand-written kernels' wgmma route)

Every preset trains with the NVCache persistence stack: synchronous-
durability checkpoints, resumable data pipeline, metrics JSONL.  Runs on
the CUDA card unless ``--device cpu`` is given.

Usage:  PYTHONPATH=src python examples/torch_train_e2e.py --preset tiny --steps 30 [--device cpu]
"""
import argparse

from repro_torch.core import NVCache, Policy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import BLOB, Tier
from repro_torch.train import loop as train_loop

PRESETS = {
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab=512, head_dim=16, batch=4, seq=64),
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                  vocab=8192, head_dim=32, batch=4, seq=128),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                 vocab=32768, head_dim=64, batch=8, seq=512),
}


def main(argv=None) -> dict:
    """Trains and prints the summary; returns it (steps, first and last
    loss, mean step time, NVCache stats) with the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = dict(PRESETS[args.preset])
    batch, seq = p.pop("batch"), p.pop("seq")
    cfg = ModelConfig(arch=f"e2e-{args.preset}", family="dense",
                      tie_embeddings=True, attn_block=256, **p)
    model = build(cfg)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    nv = NVCache(Policy(entry_size=65536, log_entries=4096,
                        read_cache_pages=256, batch_min=16, batch_max=1024,
                        verify_crc=False), Tier(BLOB))
    try:
        pipe = SyntheticTokens(cfg.vocab, batch, seq, seed=0)
        _, hist = train_loop.train(model, AdamW(lr=3e-4,
                                                schedule=warmup_cosine(20, args.steps)),
                                   pipe, NVCacheFS(nv), total_steps=args.steps,
                                   ckpt_every=args.ckpt_every, device=args.device)
        step_s = sum(h["step_time"] for h in hist) / len(hist)
        print(f"steps: {len(hist)}  loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
        print(f"avg step time: {step_s:.3f}s")
        stats = nv.stats()
        print("nvcache:", stats)
    finally:
        nv.shutdown()
    return {"steps": len(hist), "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "step_s": step_s, "nvcache": stats, "history": hist}


if __name__ == "__main__":
    main()
