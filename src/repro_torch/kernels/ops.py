"""Dispatch to the hand-written kernels.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor goes to the kernel, whose wrapper launches it or raises.
There is no fallback from one to the other.  A tensor on ``meta`` (shapes
and dtypes only, no data: the dry run's route, ``launch/dryrun.py``) goes
to the plain version too, which is what the dry run counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda

PLAIN_DEVICES = ("cpu", "meta")   # the devices whose tensors take the plain versions


# ---------------------------------------------------------- flash attention

def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv) (MLA:
    D 96, Dv 64), which may be a strided view.  Returns (B, Sq, H, Dv).
    ``window`` None or 0 is off; ``scale`` defaults to 1/sqrt(D).  A query
    that sees no key gives 0 on both routes.  Differentiable on both:
    autograd through the plain version on the CPU, the backward kernel on
    the card.  The card's kernels take D and Dv up to 128 and raise above."""
    if q.device.type in PLAIN_DEVICES:
        return _ref.attention_ref(q, k, v, causal=causal, window=window or 0,
                                  scale=scale)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale)


# --------------------------------------------------------------------- SSD

def ssd(x, dt, A, B, C, *, chunk=256):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n); ``s % chunk == 0``.
    Returns (y in x.dtype, final float32 state (b,h,p,n)).  Dtypes pass
    through as they come: nothing is cast on the host."""
    if x.device.type in PLAIN_DEVICES:
        return _ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    return ssd_cuda(x, dt, A, B, C, chunk=chunk)


# ----------------------------------------------------------------- quantize

def quantize(x, *, group=256):
    """Symmetric int8 group quantization along the last axis.  Returns
    (q int8 of x's shape, float32 scales (..., last / group)), the same bits
    on both routes."""
    if x.device.type in PLAIN_DEVICES:
        return _ref.quantize_ref(x, group=group)
    return quantize_cuda(x, group=group)


def dequantize(q, scale, *, group=256, dtype=torch.float32):
    """``q * scale`` in ``dtype``.  Plain torch on both devices: the JAX
    package has no kernel for it either."""
    return _ref.dequantize_ref(q, scale, group=group, dtype=dtype)
