"""Symmetric int8 group quantization as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.quantize.quantize_pallas``; the kernel is
``repro_torch/csrc/quantize.cu`` (design and bound in its header).
``repro_torch.kernels._build`` compiles it with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface at first use, under ``build/`` at
the root of the checkout; it is called through ``ctypes``.

The plain version of the same function is
``repro_torch.kernels.ref.quantize_ref``; ``repro_torch.kernels.ops`` sends
CPU tensors there and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.runtime.ranges import span

SRC = _build.CSRC / "quantize.cu"
SPAN = "k2.quantize"        # the profiler range around a call's launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Path:
    """Compile the kernel into ``build/`` unless it is there already."""
    return _build.build(SRC)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = ctypes.CDLL(str(build())).quantize_int8
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def quantize_cuda(x, *, group=256):
    """x: float32 or bfloat16 on a CUDA device, contiguous, last dim
    divisible by ``group``.  Returns (q: int8 of x's shape, scales: float32
    ``(..., last / group)``), equal bit for bit to ``ref.quantize_ref``.

    Adds one to ``quantize_cuda.launches`` per kernel launch."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or group <= 0 or x.shape[-1] % group:
        raise ValueError(f"last dim of {tuple(x.shape)} is not a multiple of group {group}")
    if not x.is_contiguous():
        raise ValueError("quantize_cuda needs a contiguous tensor")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], x.shape[-1] // group), dtype=torch.float32,
                         device=x.device)
    if x.numel() == 0:
        return q, scales
    vec = 4 if group % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 else 1
    with span(SPAN), torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), q.data_ptr(), scales.data_ptr(), _DTYPE_CODE[x.dtype],
                       x.numel() // group, group, vec,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 launch failed (CUDA error {err})")
    quantize_cuda.launches += 1
    return q, scales


quantize_cuda.launches = 0
