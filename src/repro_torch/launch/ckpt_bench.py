"""The checkpoint path's bench: the port of ``benchmarks/ckpt_bench.py``.

    python -m repro_torch.launch.ckpt_bench [--mib 16] [--device cuda] [--state llama]

Compares save() critical-path latency and durability for a training state
across four stacks, through the port's ``CheckpointManager``:
  * blob-sync      — synchronous write to the blob tier (no booster)
  * nvcache        — the paper's technique: durable at NVMM speed, drained
                     to blob in background (drain time reported separately)
  * page-cache     — volatile write-back (fast but loses the step on crash)
  * nvcache+int8   — NVCache with int8-quantized shards

The state lives on ``--device`` (default ``cuda``).  On the card the timed
``save`` includes each leaf's copy to the host, since the codec takes
tensors; the restore is copied back onto the device and held to the state,
exactly (int8: the parameters within 0.05, as the JAX bench holds them).
``--state llama`` saves llama3.2-1b's full-width train state from
``init_train_state`` in place of the synthetic one.  The NVMM log is
``max(64, 4 * mib)`` MiB of host memory, as the JAX bench sizes it (for
``--state llama``, ``mib`` is the state's size); each stack is let go
before the next is made.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.core import NVCache, Policy
from repro_torch.storage import tiers
from repro_torch.storage.fsapi import NVCacheFS, TierFS

# ``benchmarks/backends.py``'s device-time scale and the checkpoint policy
# the JAX bench takes from it, ``backends.policy(log_mib, entry=65536)``
# (that module imports the JAX package, so the port keeps its own copy):
# 64 KiB entries and no per-entry CRC; backends leaves every other field
# at ``Policy``'s default
SCALE = 20.0
ENTRY = 65536


def checkpoint_policy(log_mib: float) -> Policy:
    return Policy(entry_size=ENTRY, log_entries=max(8, int(log_mib * 1024 * 1024 // ENTRY)),
                  verify_crc=False)


def _state(mib: float = 16, seed=0, device="cpu"):
    """The JAX bench's synthetic state (the same numpy draws) on ``device``."""
    rng = np.random.default_rng(seed)
    n = int(mib * (1 << 20) / 4 / 4)
    w = rng.standard_normal((4, n)).astype(np.float32)
    m = rng.standard_normal((4, n)).astype(np.float32) * .01
    v = rng.standard_normal((4, n)).astype(np.float32) ** 2
    return {"params": {"w": torch.from_numpy(w).to(device)},
            "opt": {"m": torch.from_numpy(m).to(device), "v": torch.from_numpy(v).to(device),
                    "step": torch.tensor(7, dtype=torch.int32, device=device)}}


def llama_state(device="cuda", seed=0):
    """llama3.2-1b's full-width train state (f32 parameters and moments)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import init_train_state
    device = torch.device(device)
    return init_train_state(build(get_config("llama3.2-1b")), AdamW(),
                            torch.Generator(device).manual_seed(seed))


def state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(state))


def _restored(got, state, int8: bool) -> bool:
    """The restore, copied onto the state's device, against the state:
    every leaf equal, or with int8 the parameters within 0.05 (the JAX
    bench's ``np.allclose(..., atol=0.05)`` on ``params/w``)."""
    got = dict(flatten(got))
    if int8:
        return all(torch.allclose(got[key].to(leaf.device).float(), leaf.float(),
                                  rtol=1e-5, atol=0.05)
                   for key, leaf in flatten(state) if key.startswith("params/"))
    return all(torch.equal(got[key].to(leaf.device), leaf) for key, leaf in flatten(state))


def run(mib: float = 16, *, device="cpu", state=None):
    """Rows {stack, save_s, drain_s, bytes, restore_ok, state_bytes,
    save_mib_s} for the four stacks, printed as the JAX bench prints them.
    ``state`` in place of the synthetic state of ``mib`` MiB a leaf."""
    if state is None:
        state = _state(mib, device=device)
    else:
        mib = state_bytes(state) / (1 << 20)
    nbytes = state_bytes(state)
    rows = []

    def bench(name, make, encoding=codec.ENC_ZSTD):
        fs, nv = make()
        mgr = CheckpointManager(fs, keep=2, encoding=encoding)
        if device != "cpu":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        info = mgr.save(1, state)
        t_save = time.perf_counter() - t0      # durability latency (critical path)
        t0 = time.perf_counter()
        if nv is not None:
            nv.flush()                          # background drain to blob
        mgr.finalize()
        t_drain = time.perf_counter() - t0
        ok = _restored(mgr.restore(state), state, encoding == codec.ENC_INT8)
        rows.append({"stack": name, "save_s": t_save, "drain_s": t_drain,
                     "bytes": info["size"], "restore_ok": ok, "state_bytes": nbytes,
                     "save_mib_s": nbytes / (1 << 20) / t_save})
        print(f"ckpt/{name},{1e6 * t_save:.0f},"
              f"save={t_save:.3f}s drain={t_drain:.3f}s "
              f"size={info['size'] / (1 << 20):.1f}MiB ok={ok}", flush=True)
        if nv is not None:
            nv.shutdown()
        del fs, nv, mgr
        gc.collect()   # NVCache's threads hold it in reference cycles: free its log now

    def tier_fs(sync):
        return lambda: (TierFS(tiers.Tier(tiers.BLOB, sync=sync, scale=SCALE)), None)

    # checkpoint-tuned NVCache: 64 KiB entries (large sequential writes ->
    # fewer, bigger log entries; the entry size is a first-class Policy knob)
    def nv_stack():
        nv = NVCache(checkpoint_policy(max(64, mib * 4)),
                     tiers.Tier(tiers.BLOB, sync=False, scale=SCALE))
        return NVCacheFS(nv), nv

    bench("blob-sync", tier_fs(True))
    bench("nvcache", nv_stack)
    bench("page-cache-unsafe", tier_fs(False))
    bench("nvcache+int8", nv_stack, encoding=codec.ENC_INT8)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=float, default=16, help="synthetic state size")
    ap.add_argument("--state", choices=("synthetic", "llama"), default="synthetic")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    state = llama_state(args.device) if args.state == "llama" else None
    rows = run(args.mib, device=args.device, state=state)
    print(json.dumps({"state": args.state, "device": args.device, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
