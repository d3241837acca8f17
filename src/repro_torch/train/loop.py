"""Training loop with NVCache-backed persistence: the port of
``repro.train.loop`` on one device.

Every durable artifact — checkpoints, data-pipeline state, metrics JSONL —
goes through the plain file API; when that FS is NVCache-backed, a step's
checkpoint is synchronously durable at fast-tier speed and drains to the
blob tier in the background.  On restart the loop recovers: NVCache log
replay -> manifest -> restore -> resume the data pipeline at the exact step.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.train import steps as tsteps


class MetricsLog:
    """JSONL metrics through the FS (another 'legacy' NVCache consumer)."""

    def __init__(self, fs, path: str = "/metrics.jsonl"):
        self.fs = fs
        self.fd = fs.open(path)
        self.off = fs.size(self.fd)

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        line = (json.dumps(rec) + "\n").encode()
        self.fs.pwrite(self.fd, line, self.off)
        self.off += len(line)


def train(model: Model, optimizer: AdamW, pipeline, fs, *,
          total_steps: int, ckpt_every: int = 50, keep: int = 2, seed: int = 0,
          heartbeat: Optional[Callable[[int], None]] = None,
          compress_grads: bool = False, device="cuda"):
    """Returns (final_state, history list of metric dicts).  The state lives
    on ``device`` and is updated in place by each step; each step waits for
    its loss, as the JAX loop blocks on it."""
    device = torch.device(device)
    mgr = CheckpointManager(fs, keep=keep)
    metrics_log = MetricsLog(fs)
    step_fn = tsteps.make_train_step(model, optimizer, compress=compress_grads)

    # ---- restore or init ---------------------------------------------------
    state = tsteps.init_train_state(model, optimizer,
                                    torch.Generator(device).manual_seed(seed))
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        restored = dict(flatten(mgr.restore(state, step=latest)))
        for key, leaf in flatten(state):
            leaf.copy_(restored[key])        # casts to the state's dtype and device
        pipeline.restore_state(fs)
        start = latest
    history = []

    for step in range(start, total_steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipeline.next().items()}
        t0 = time.perf_counter()
        metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
        metrics["step_time"] = time.perf_counter() - t0
        metrics_log.log(step, metrics)
        history.append(metrics)
        if heartbeat:
            heartbeat(step)
        if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
            mgr.save(step + 1, state)
            pipeline.save_state(fs)
    return state, history
