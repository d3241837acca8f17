"""Training loop with NVCache-backed persistence: the port of
``repro.train.loop``.

Every durable artifact — checkpoints, data-pipeline state, metrics JSONL —
goes through the plain file API; when that FS is NVCache-backed, a step's
checkpoint is synchronously durable at fast-tier speed and drains to the
blob tier in the background.  On restart the loop recovers: NVCache log
replay -> manifest -> restore -> resume the data pipeline at the exact step.
Each step's phases are profiler ranges (``runtime/ranges.py``):
``train.batch``, ``train.step`` and ``train.log``; the caller's
``heartbeat`` and the checkpoints run outside them.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.ranges import span
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
          total_steps: int, ckpt_every: int = 50, keep: int = 2,
          mesh=None, fsdp: bool = True, seed: int = 0,
          heartbeat: Optional[Callable[[int], None]] = None,
          compress_grads: bool = False, device="cuda"):
    """Returns (final_state, history list of metric dicts).  The state lives
    on ``device`` and is updated in place by each step; each step waits for
    its loss, as the JAX loop blocks on it.

    On a ``mesh`` (``launch/mesh.py``) every rank of the job calls this with
    the same arguments, on the mesh's device type.  Each draws the same
    global state and batches from the same seeds and keeps its shards of
    them (``train_shardings``; the batch over the data axes).  At a
    checkpoint every rank gathers each leaf whole (a collective) and rank 0
    alone writes it, the pipeline's position and the metrics through its
    ``fs``.  A resume restores on rank 0, and ``distribute_tensor``
    scatters its state to the others; rank 0 also sends them the step and
    the pipeline's position."""
    if mesh is not None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    device = torch.device(device)
    writer = mesh is None or dist.get_rank() == 0
    mgr = CheckpointManager(fs, keep=keep) if writer else None
    metrics_log = MetricsLog(fs) if writer else None
    step_fn = tsteps.make_train_step(model, optimizer, compress=compress_grads)

    # ---- restore or init ---------------------------------------------------
    state = tsteps.init_train_state(model, optimizer,
                                    torch.Generator(device).manual_seed(seed))
    latest = mgr.latest_step() if writer else None
    if latest is not None:
        restored = dict(flatten(mgr.restore(state, step=latest)))
        for key, leaf in flatten(state):
            leaf.copy_(restored[key])        # casts to the state's dtype and device
        pipeline.restore_state(fs)
    if mesh is not None:
        shared = [latest, pipeline.state()]
        dist.broadcast_object_list(shared, src=0)
        latest = shared[0]
        pipeline.load_state(shared[1])
        (placed, _), _ = tsteps.train_shardings(model, optimizer, mesh, {}, fsdp=fsdp)
        state = shd.distribute(state, mesh, placed,
                               src_data_rank=None if latest is None else 0)
        step_fn = tsteps.bind_mesh(step_fn, mesh)
    start = latest or 0
    history = []

    for step in range(start, total_steps):
        with span("train.batch"):
            batch = {k: torch.from_numpy(v).to(device) for k, v in pipeline.next().items()}
            if mesh is not None:
                batch = shd.distribute(batch, mesh, shd.batch_specs(batch, mesh),
                                       src_data_rank=None)
        t0 = time.perf_counter()
        with span("train.step"):
            metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
        metrics["step_time"] = time.perf_counter() - t0
        if writer:
            with span("train.log"):
                metrics_log.log(step, metrics)
        history.append(metrics)
        if heartbeat:
            heartbeat(step)
        if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
            whole = shd.full(state) if mesh is not None else state
            if writer:
                mgr.save(step + 1, whole)
                pipeline.save_state(fs)
    return state, history
