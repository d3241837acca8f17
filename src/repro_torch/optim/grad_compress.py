"""Gradient compression: the port of ``repro.optim.grad_compress``.

``compress_tree`` int8 group-quantizes and dequantizes every gradient leaf
(on the card through the hand-written K2, ``csrc/quantize.cu``), which is
the error an int8 gradient exchange would put into training; a DTensor
leaf is compressed shard by shard, each rank its own.
``compressed_psum`` is the explicit int8 all-reduce of a rank's local
tensor over a process group: the JAX version's ``shard_map`` counterpart.
"""
from __future__ import annotations

import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops as kops


def _leaf_compress(g, group):
    if isinstance(g, DTensor):
        # each rank's shard in its own groups: the JAX version's groups run
        # over the whole flattened leaf (equal on a 1x1 mesh)
        pl = tuple(g.placements)
        return local_map(lambda t: _leaf_compress(t, group), out_placements=(pl,),
                         in_placements=(pl,), device_mesh=g.device_mesh)(g)
    flat = g.reshape(-1)
    pad = (-flat.numel()) % group
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = kops.quantize(flat, group=group)
    deq = kops.dequantize(q, s, group=group, dtype=g.dtype)
    return deq[:g.numel()].reshape(g.shape)


def compress_tree(grads, *, group: int = 256):
    """Quantize->dequantize every leaf (simulates int8 gradient exchange)."""
    return {k: compress_tree(v, group=group) if isinstance(v, dict) else _leaf_compress(v, group)
            for k, v in grads.items()}


def compressed_psum(x, group, *, group_size: int = 256):
    """The sum of every rank's ``x`` over the process group ``group``,
    exchanged as int8 (an all-gather-based all-reduce, as JAX's inside
    ``shard_map``): pad to the group size, quantize with K2 on the card,
    all-gather the int8 payload and the float32 scales (~4x fewer bytes on
    the link than a float32 all-reduce), dequantize each rank's row, sum in
    float32 and cast back to x's dtype.  Every rank returns the same sum."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % group_size
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = kops.quantize(flat, group=group_size)
    n = dist.get_world_size(group)
    qs = q.new_empty(n * q.numel())
    ss = s.new_empty(n * s.numel())
    dist.all_gather_into_tensor(qs, q, group=group)       # int8 on the wire
    dist.all_gather_into_tensor(ss, s, group=group)
    vals = kops.dequantize(qs.view(n, -1), ss.view(n, -1), group=group_size)   # float32
    return vals.sum(0)[:x.numel()].reshape(x.shape).to(x.dtype)
