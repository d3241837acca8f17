"""Quickstart on the PyTorch port: NVCache as a plug-and-play I/O booster.

  1. open a file through NVCache and write — durable at NVMM speed;
  2. read it back (read-your-writes while the slow tier is stale);
  3. pull the power mid-flight, run the paper's recovery, verify no
     committed byte was lost;
  4. train a tiny LM (``repro_torch``) with NVCache-backed checkpoints and
     resume it.

Usage:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the model trains on the CUDA card unless ``--device cpu`` is given).
"""
import argparse

from repro_torch.configs.registry import get_smoke
from repro_torch.core import NVCache, Policy, recover
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import DRAM, SSD_SATA, Tier
from repro_torch.train import loop as train_loop

POL = Policy(entry_size=4096, log_entries=4096, read_cache_pages=64,
             batch_min=16, batch_max=256)


def io_booster_demo():
    print("== 1-3: write / read / crash / recover ==")
    tier = Tier(SSD_SATA, sync=False)          # the slow tier ("SSD")
    nv = NVCache(POL, tier, track_crashes=True)
    fd = nv.open("/demo.dat")
    nv.pwrite(fd, b"synchronously durable!" * 100, 0)
    assert nv.pread(fd, 22, 0) == b"synchronously durable!"
    print("   write returned -> bytes are durable in the NVMM log")
    print(f"   log entries in flight: {nv.log.used_entries}")

    nvmm = nv.crash()                          # power loss, nothing drained
    print("   power loss! recovering from the NVMM log...")
    tier2 = Tier(SSD_SATA, sync=False)
    stats = recover(nvmm, POL, tier2.open)
    got = tier2.open("/demo.dat").snapshot()
    assert got[:22] == b"synchronously durable!"
    print(f"   recovered {stats.entries_replayed} entries, "
          f"{stats.bytes_replayed} bytes — no committed write lost\n")
    return stats


def training_demo(device="cuda"):
    """Returns the first run's history and the resumed run's."""
    print(f"== 4: training with NVCache-backed checkpoints ({device}) ==")
    cfg = get_smoke("llama3.2-1b")
    model = build(cfg)
    nv = NVCache(POL, Tier(DRAM))
    fs = NVCacheFS(nv)
    try:
        pipe = SyntheticTokens(cfg.vocab, 2, 32, seed=0)
        _, hist = train_loop.train(model, AdamW(lr=1e-3), pipe, fs,
                                   total_steps=20, ckpt_every=10, device=device)
        print(f"   trained 20 steps: loss {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f}")
        # resume: a fresh loop picks up at the last durable checkpoint
        pipe2 = SyntheticTokens(cfg.vocab, 2, 32, seed=0)
        _, hist2 = train_loop.train(model, AdamW(lr=1e-3), pipe2, fs,
                                    total_steps=25, ckpt_every=10, device=device)
        print(f"   resumed at step {pipe2.step - len(hist2)}, ran {len(hist2)} more steps")
    finally:
        nv.shutdown()
    return hist, hist2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    io_booster_demo()
    hist, hist2 = training_demo(args.device)
    print("quickstart OK")
    return hist, hist2


if __name__ == "__main__":
    main()
