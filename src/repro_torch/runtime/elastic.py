"""Elastic scaling: re-mesh to a surviving device count and re-slice the
checkpoint to the new topology: the port of ``repro.runtime.elastic``.

The checkpoint codec stores row-chunked leaves with global shapes, so a
host joining a smaller/larger mesh restores exactly the rows of each leaf
its shard owns (``repro_torch.checkpoint.manager.CheckpointManager.restore``'s
``slice_rows``).  The mesh itself comes with the distribution slice; the
functions here are plain Python over shapes and the manager.
"""
from __future__ import annotations

from typing import Optional, Tuple


def viable_mesh(n_devices: int, *, model_parallel: int = 16,
                multi_pod_threshold: int = 512) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) grid that fits the surviving devices,
    keeping the model axis intact (TP degree is fixed by memory), shedding
    data-parallel rows first — the standard elastic policy."""
    if n_devices % model_parallel:
        model_parallel = _largest_pow2_divisor(n_devices, model_parallel)
    data = n_devices // model_parallel
    if n_devices >= multi_pod_threshold and data % 2 == 0:
        return (2, data // 2, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def _largest_pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def shard_rows(key: str, global_shape: tuple, *, shard_idx: int,
               n_shards: int) -> Optional[tuple]:
    """Row range of leaf ``key`` owned by FSDP shard ``shard_idx``.

    Row-sharding applies to rank>=2 leaves whose leading dim divides the
    shard count; vectors/scalars (norm weights, counters) replicate —
    matching the partition rules of the JAX package's
    ``parallel/sharding.py``."""
    if len(global_shape) < 2 or global_shape[0] % n_shards:
        return None
    per = global_shape[0] // n_shards
    return (shard_idx * per, (shard_idx + 1) * per)


def reshard_restore(manager, tree_like, *, shard_idx: int, n_shards: int,
                    step: Optional[int] = None):
    """Restore this shard's slice of every leaf for a new topology."""
    def slicer(key, shape):
        return shard_rows(key, shape, shard_idx=shard_idx, n_shards=n_shards)
    return manager.restore(tree_like, step=step, slice_rows=slicer)
