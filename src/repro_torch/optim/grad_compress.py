"""Gradient compression: the port of ``repro.optim.grad_compress``.

``compress_tree`` int8 group-quantizes and dequantizes every gradient leaf
(on the card through the hand-written K2, ``csrc/quantize.cu``), which is
the error an int8 gradient exchange would put into training.
``compressed_psum`` comes with the distribution slice.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def _leaf_compress(g, group):
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
