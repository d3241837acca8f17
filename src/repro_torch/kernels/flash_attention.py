"""Flash attention (forward) as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``; the
kernel is ``repro_torch/csrc/flash_attention.cu`` (design and bound in its
header).  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, under ``build/`` at the
root of the checkout, and called through ``ctypes``.

The plain version of the same function is
``repro_torch.kernels.ref.attention_ref``; ``repro_torch.kernels.ops``
sends CPU tensors there and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Path:
    """Compile the kernel unless a library built from this exact source is
    already in ``build/``; returns the library's path.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept next
    to it as ``<library>.log``."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_attention-{digest}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{lib}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{res.stderr[-6000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _entry():
    fn = ctypes.CDLL(str(build())).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) on one CUDA device, float32
    or bfloat16, last dim contiguous.  Returns (B, Sq, H, D) in q.dtype.

    ``window`` None or 0 is off; otherwise key j is visible to query i iff
    j > i - window.  Adds one to ``flash_attention_cuda.launches`` per
    kernel launch.  Forward only: inputs that require grad are refused."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (tuple(k.shape) != (B, Skv, KV, D) or tuple(v.shape) != (B, Skv, KV, D)
            or D not in HEAD_DIMS or KV == 0 or H % KV):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: head dim in {HEAD_DIMS}, H % KV == 0")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError("flash_attention_cuda is forward-only; the backward "
                                  "kernel comes with the training slice")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_cuda needs the last dim contiguous")
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError("bfloat16 q/k/v need 16-byte aligned rows "
                             "(base pointer and strides)")
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window >= Sq:          # i - window < 0 <= j for every row: no key is cut
        window = 0
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODE[q.dtype],
            B, Sq, Skv, H, KV, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale, int(bool(causal)), window,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed (CUDA error {err})")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
