"""Flash attention, forward and backward, as hand-written CUDA kernels for
Hopper.

The forward ports ``repro.kernels.flash_attention.flash_attention_pallas``
(``repro_torch/csrc/flash_attention.cu``); the backward
(``repro_torch/csrc/flash_attention_bwd.cu``) has no TPU counterpart: the
JAX package differentiates its plain attention.  Design and bounds are in
the sources' headers.  ``repro_torch.kernels._build`` compiles each with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use, under ``build/`` at the root of the checkout; they are called
through ``ctypes``.  :func:`flash_attention` ties the two together as a
``torch.autograd.Function``.

The plain version of the same function is
``repro_torch.kernels.ref.attention_ref`` (its gradient: autograd through
it); ``repro_torch.kernels.ops`` sends CPU tensors there and CUDA tensors
here.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SRC = _build.CSRC / "flash_attention.cu"
BWD_SRC = _build.CSRC / "flash_attention_bwd.cu"
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)   # bf16 head dims that run the wgmma kernels
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build() -> Path:
    """Compile the forward kernel into ``build/`` unless it is there already."""
    return _build.build(SRC)


def build_bwd() -> Path:
    """Compile the backward kernels into ``build/`` unless they are there already."""
    return _build.build(BWD_SRC)


def load_fwd(lib: Path):
    """The ``flash_attention_fwd`` entry point of a built library."""
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def load_bwd(lib: Path):
    """The ``flash_attention_bwd`` entry point of a built library."""
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry():
    return load_fwd(build())


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    return load_bwd(build_bwd())


def _check(q, k, v, window, name):
    """Validate q/k/v for the kernels; returns the window as the kernels
    take it (0 = off)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{name} needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (tuple(k.shape) != (B, Skv, KV, D) or tuple(v.shape) != (B, Skv, KV, D)
            or D not in HEAD_DIMS or KV == 0 or H % KV):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: head dim in {HEAD_DIMS}, H % KV == 0")
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return 0 if window >= Sq else window   # i - window < 0 <= j for every row: no key is cut


def _check_rows(ts, name):
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs the last dim contiguous")
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError("bfloat16 q/k/v/o/dO need 16-byte aligned rows "
                             "(base pointer and strides)")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) on one CUDA device, float32
    or bfloat16, last dim contiguous.  Returns (B, Sq, H, D) in q.dtype and,
    with ``return_lse``, the float32 (B, H, Sq) log-sum-exp of each row's
    scaled scores (+inf for a row that sees no key).

    ``window`` None or 0 is off; otherwise key j is visible to query i iff
    j > i - window.  Adds one to ``flash_attention_cuda.launches`` per
    kernel launch.  Records no gradient: :func:`flash_attention` does."""
    B, Sq, H, D = q.shape
    window = _check(q, k, v, window, "flash_attention_cuda")
    _check_rows((q, k, v), "flash_attention_cuda")
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if not scale > 0:
        raise ValueError(f"scale must be positive (the kernels keep the raw scores' "
                         f"running max), got {scale}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel():
        with torch.cuda.device(q.device):
            err = _entry()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if return_lse else None, _DTYPE_CODE[q.dtype],
                B, Sq, k.shape[1], H, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *o.stride()[:3], scale, int(bool(causal)), window,
                torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed (CUDA error {err})")
        flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def _bwd_scratch(q):
    """The backward's fp32 scratch: the row sums D = rowsum(dO * O), B * H *
    Sq floats, and, for the bf16 wgmma kernels (D in ``WGMMA_HEAD_DIMS``),
    after them (at the next multiple of 4 floats) the zeroed (B, Sq, H, D)
    dQ accumulator that their atomics add into."""
    B, Sq, H, D = q.shape
    n = B * H * Sq
    if q.dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return torch.zeros(-(-n // 4) * 4 + B * Sq * H * D, dtype=torch.float32, device=q.device)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True, window=0, scale=None):
    """Gradients (dq, dk, dv) of ``flash_attention_cuda`` at (q, k, v), given
    its output ``o``, its ``lse`` and the output's gradient ``do`` (all on one
    CUDA device; o and do shaped and typed as q).  dk and dv are summed over
    the query heads of each kv head (GQA).

    Adds one to ``flash_attention_bwd_cuda.launches`` per call.  A call runs
    three kernels: the row sums D = rowsum(dO * O), then, for bf16 at D 64
    or 128, the wgmma kernel (dK, dV, and dQ added with atomics into an fp32
    accumulator) and the kernel that scales that into dq; otherwise dQ, then
    dK/dV."""
    B, Sq, H, D = q.shape
    window = _check(q, k, v, window, "flash_attention_bwd_cuda")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be shaped "
                         f"as q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or o.device != q.device or do.device != q.device:
        raise TypeError("o and do must have q's dtype and device")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be a contiguous float32 (B, H, Sq) tensor on q's device")
    _check_rows((q, k, v, o, do), "flash_attention_bwd_cuda")
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = _bwd_scratch(q)
    with torch.cuda.device(q.device):
        err = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, k.shape[1], H, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], scale, int(bool(causal)), window,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed (CUDA error {err})")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """``flash_attention_cuda`` with its gradient through
    ``flash_attention_bwd_cuda``.  Only when autograd records (grad mode on
    and an input that requires grad) does the forward write the
    log-sum-exp the backward needs; otherwise it is the serving kernel as it
    is."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
