"""Dispatch to the hand-written kernels.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor goes to the kernel, whose wrapper launches it or raises.
There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda


# ---------------------------------------------------------- flash attention

def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D).  ``window`` None or 0 is off.
    A query that sees no key gives 0 on both routes."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window or 0,
                                  scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
