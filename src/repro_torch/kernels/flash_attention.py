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

q and k have head dim D, v and the output their own head dim Dv (MLA: 96
and 64), each at most 128; :func:`route` names the kernels a call runs.
The kernels read every operand through its strides (a view such as MLA's
``kvb[..., nd:]`` goes in as it is) and zero-fill a head dim up to the
width they were built for; nothing is padded or copied here.

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
from repro_torch.runtime.ranges import span

SRC = _build.CSRC / "flash_attention.cu"
BWD_SRC = _build.CSRC / "flash_attention_bwd.cu"
FWD_SPAN = "k1.fwd"         # the profiler range around a forward's launches
BWD_SPAN = "k1.bwd"         # and around a backward's
MAX_HEAD_DIM = 128           # of q/k and of v; no config of the repo has more
ROUTES = ("fma", "mma", "wgmma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype, D: int, Dv: int) -> str:
    """The kernels a call at q/k head dim D and v head dim Dv runs, forward
    and backward alike: "fma" (float32, fp32 FMAs), "mma" (bfloat16 with D
    and Dv at most 32, ``mma.sync``) or "wgmma" (bfloat16 otherwise, the
    Hopper kernels, at widths D in {64, 96, 128}, Dv in {64, 128})."""
    if dtype == torch.float32:
        return "fma"
    return "mma" if D <= 32 and Dv <= 32 else "wgmma"


def build() -> Path:
    """Compile the forward kernel into ``build/`` unless it is there already."""
    return _build.build(SRC)


def build_bwd() -> Path:
    """Compile the backward kernels into ``build/`` unless they are there already."""
    return _build.build(BWD_SRC)


def load_fwd(lib: Path):
    """The ``flash_attention_fwd`` entry point of a built library."""
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def load_bwd(lib: Path):
    """The ``flash_attention_bwd`` entry point of a built library."""
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
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


def _check_device(ts, name):
    if any(t.device.type != "cuda" or t.device != ts[0].device for t in ts):
        raise ValueError(f"{name} needs its tensors on one CUDA device, "
                         f"got {', '.join(str(t.device) for t in ts)}")


def _check(q, k, v, window, name):
    """Validate q/k/v for the kernels, on any device; returns the window as
    the kernels take it (0 = off)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    Dv = v.shape[-1]
    if (tuple(k.shape) != (B, Skv, KV, D) or tuple(v.shape) != (B, Skv, KV, Dv)
            or KV == 0 or H % KV):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: k as q but for its kv heads, v as k but "
                         f"for its head dim, H % KV == 0")
    if not (0 < D <= MAX_HEAD_DIM and 0 < Dv <= MAX_HEAD_DIM):
        raise ValueError(f"{name} takes head dims 1-{MAX_HEAD_DIM}, got D {D} (q, k) "
                         f"and Dv {Dv} (v)")
    if q.dtype == torch.bfloat16 and (D % 8 or Dv % 8):
        raise ValueError(f"{name}: bfloat16 head dims must be multiples of 8 (16-byte "
                         f"rows), got D {D}, Dv {Dv}")
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


def launch_fwd(entry, q, k, v, *, causal, window, scale, return_lse, stream):
    """Run a forward library's entry point (from :func:`load_fwd`) on q, k,
    v wherever they lie, on the stream handle ``stream``: checks them (all
    but the device), allocates o (and lse) beside q and returns (o, lse or
    None).  Raises if the entry reports an error.  Counts nothing."""
    B, Sq, H, D = q.shape
    window = _check(q, k, v, window, "flash_attention_cuda")
    _check_rows((q, k, v), "flash_attention_cuda")
    Dv = v.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if not scale > 0:
        raise ValueError(f"scale must be positive (the kernels keep the raw scores' "
                         f"running max), got {scale}")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel():
        with span(FWD_SPAN):
            err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr() if return_lse else None, _DTYPE_CODE[q.dtype],
                        B, Sq, k.shape[1], H, k.shape[2], D, Dv, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], scale,
                        int(bool(causal)), window, stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed (CUDA error {err})")
    return o, lse


def flash_attention_cuda(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    """q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv) on one CUDA
    device, float32 or bfloat16, last dim contiguous, D and Dv at most 128
    (multiples of 8 in bfloat16).  Returns (B, Sq, H, Dv) in q.dtype and,
    with ``return_lse``, the float32 (B, H, Sq) log-sum-exp of each row's
    scaled scores (+inf for a row that sees no key).

    ``window`` None or 0 is off; otherwise key j is visible to query i iff
    j > i - window.  ``scale`` defaults to 1/sqrt(D).  Adds one to
    ``flash_attention_cuda.launches`` per kernel launch and to
    ``flash_attention_cuda.routes`` under its :func:`route`.  Records no
    gradient: :func:`flash_attention` does."""
    _check_device((q, k, v), "flash_attention_cuda")
    with torch.cuda.device(q.device):
        o, lse = launch_fwd(_entry(), q, k, v, causal=causal, window=window, scale=scale,
                            return_lse=return_lse,
                            stream=torch.cuda.current_stream(q.device).cuda_stream)
    if o.numel():
        flash_attention_cuda.launches += 1
        flash_attention_cuda.routes[route(q.dtype, q.shape[3], v.shape[3])] += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(ROUTES, 0)


def _bwd_scratch(q, Dv):
    """The backward's fp32 scratch: the row sums D = rowsum(dO * O), B * H *
    Sq floats, and, for the wgmma route (Dv is v's head dim), after them (at
    the next multiple of 4 floats) the (B, Sq, H, D) dQ accumulator that its
    atomics add into; on that route all of it is zeroed, since from 8 query
    heads a kv head on the row sums are added up with atomics too."""
    B, Sq, H, D = q.shape
    n = B * H * Sq
    if route(q.dtype, D, Dv) == "wgmma":
        return torch.zeros(-(-n // 4) * 4 + B * Sq * H * D, dtype=torch.float32, device=q.device)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def launch_bwd(entry, q, k, v, o, lse, do, *, causal, window, scale, stream):
    """Run a backward library's entry point (from :func:`load_bwd`) wherever
    the tensors lie, on the stream handle ``stream``: checks them (all but
    the device), allocates dq, dk, dv and the scratch beside q and returns
    (dq, dk, dv).  Raises if the entry reports an error.  Counts nothing."""
    B, Sq, H, D = q.shape
    window = _check(q, k, v, window, "flash_attention_bwd_cuda")
    Dv = v.shape[-1]
    if tuple(o.shape) != (B, Sq, H, Dv) or tuple(do.shape) != (B, Sq, H, Dv):
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be shaped "
                         f"(B, Sq, H, Dv) = {(B, Sq, H, Dv)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("o and do must have q's dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 (B, H, Sq) tensor")
    _check_rows((q, k, v, o, do), "flash_attention_bwd_cuda")
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = _bwd_scratch(q, Dv)
    with span(BWD_SPAN):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, k.shape[1], H, k.shape[2], D,
                    Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                    *do.stride()[:3], scale, int(bool(causal)), window, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed (CUDA error {err})")
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True, window=0, scale=None):
    """Gradients (dq, dk, dv) of ``flash_attention_cuda`` at (q, k, v), given
    its output ``o``, its ``lse`` and the output's gradient ``do`` (all on one
    CUDA device; o and do (B, Sq, H, Dv), typed as q).  dk and dv are summed
    over the query heads of each kv head (GQA).

    Adds one to ``flash_attention_bwd_cuda.launches`` per call and to
    ``flash_attention_bwd_cuda.routes`` under its :func:`route`.  A call
    runs three kernels: the row sums D = rowsum(dO * O), then, on the wgmma
    route, the wgmma kernel (dK, dV, and dQ added with atomics into an fp32
    accumulator) and the kernel that scales that into dq; otherwise dQ,
    then dK/dV.  On the wgmma route with 8 or more query heads a kv head the
    wgmma kernel runs twice, first for the row sums as sums of P dP in fp32,
    then with P and dS as two bf16 terms each (``csrc/flash_attention_bwd.cu``,
    ``TWO_TERM_GROUP``)."""
    _check_device((q, k, v, o, lse, do), "flash_attention_bwd_cuda")
    with torch.cuda.device(q.device):
        grads = launch_bwd(_bwd_entry(), q, k, v, o, lse, do, causal=causal, window=window,
                           scale=scale, stream=torch.cuda.current_stream(q.device).cuda_stream)
    if grads[0].numel() and k.shape[1]:
        flash_attention_bwd_cuda.launches += 1
        flash_attention_bwd_cuda.routes[route(q.dtype, q.shape[3], v.shape[3])] += 1
    return grads


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.routes = dict.fromkeys(ROUTES, 0)


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
