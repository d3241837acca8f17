"""Dispatch to the hand-written kernels.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor goes to the kernel, whose wrapper launches it or raises.
There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda


# ---------------------------------------------------------- flash attention

def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D).  ``window`` None or 0 is off.
    A query that sees no key gives 0 on both routes.  Differentiable on
    both: autograd through the plain version on the CPU, the backward
    kernel on the card."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window or 0,
                                  scale=scale)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale)


# --------------------------------------------------------------------- SSD

def ssd(x, dt, A, B, C, *, chunk=256):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n); ``s % chunk == 0``.
    Returns (y in x.dtype, final float32 state (b,h,p,n)).  Dtypes pass
    through as they come: nothing is cast on the host."""
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    return ssd_cuda(x, dt, A, B, C, chunk=chunk)


# ----------------------------------------------------------------- quantize

def quantize(x, *, group=256):
    """Symmetric int8 group quantization along the last axis.  Returns
    (q int8 of x's shape, float32 scales (..., last / group)), the same bits
    on both routes."""
    if x.device.type == "cpu":
        return _ref.quantize_ref(x, group=group)
    return quantize_cuda(x, group=group)


def dequantize(q, scale, *, group=256, dtype=torch.float32):
    """``q * scale`` in ``dtype``.  Plain torch on both devices: the JAX
    package has no kernel for it either."""
    return _ref.dequantize_ref(q, scale, group=group, dtype=dtype)
