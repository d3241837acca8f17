"""Mamba-2 SSD chunked scan as hand-written CUDA kernels for Hopper: the
forward and its backward.

Port of ``repro.kernels.ssd_scan.ssd_pallas``; the forward's kernels are in
``repro_torch/csrc/ssd_scan.cu``, the backward's in
``repro_torch/csrc/ssd_scan_bwd.cu`` (design and bound in their headers).
``repro_torch.kernels._build`` compiles each with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at first use, under
``build/`` at the root of the checkout; they are called through ``ctypes``.
``ssd_route`` picks one of the forward's two routes before launch, and
``ssd_bwd_route`` one of the backward's, from dtype, shape and layout
alone: the chunk-parallel ``wgmma`` kernels (every product on the tensor
cores, fp32 operands as hi + lo bf16 terms) for the main path's bf16 case,
the ``fma`` kernels (scalar fp32 FMAs) for the rest.

The plain version of the forward is ``repro_torch.kernels.ref.ssd_ref``,
of the backward autograd through it; ``repro_torch.kernels.ops`` sends CPU
tensors there and CUDA tensors to :func:`ssd`, which differentiates the
forward kernel with the backward one.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SRC = _build.CSRC / "ssd_scan.cu"
BWD_SRC = _build.CSRC / "ssd_scan_bwd.cu"
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("fma", "wgmma")   # the C entry's route codes, in order


def ssd_route(x, B, C, chunk: int) -> str:
    """The route a call takes, from dtype, shape and layout alone: "wgmma"
    for bfloat16 x/B/C with head dim p = 64, state n a multiple of 16 up to
    128, a chunk that is a multiple of 64 (up to 1024) and a non-empty
    sequence, where each of x, B, C has a contiguous last dim and a 16-byte
    aligned start and other strides (the main path's views of one
    projection do); "fma" for every other input the wrapper takes."""
    n = B.shape[3]
    if not (x.dtype == B.dtype == C.dtype == torch.bfloat16 and x.shape[3] == 64
            and n % 16 == 0 and 16 <= n <= MAX_N and chunk % 64 == 0
            and 0 < chunk <= MAX_CHUNK and x.shape[1] > 0):
        return "fma"
    return "wgmma" if all(_aligned(t) for t in (x, B, C)) else "fma"


def _aligned(t) -> bool:
    """A contiguous last dim, and a 16-byte aligned start and other strides."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


def ssd_bwd_route(x, B, C, dy, chunk: int) -> str:
    """The route a backward call takes, from dtype, shape and layout alone:
    the forward's rule (``ssd_route``) with dy held to it as x is (bfloat16,
    a contiguous last dim, 16-byte aligned start and other strides)."""
    if (ssd_route(x, B, C, chunk) == "wgmma" and dy.dtype == torch.bfloat16
            and dy.shape == x.shape and _aligned(dy)):
        return "wgmma"
    return "fma"


def build() -> Path:
    """Compile the kernel into ``build/`` unless it is there already."""
    return _build.build(SRC)


@functools.lru_cache(maxsize=None)
def _entry():
    return load(build())


def load(lib: Path):
    """The C entry point of a library built from ``ssd_scan.cu``."""
    fn = ctypes.CDLL(str(lib)).ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(entry, x, dt, A, B, C, chunk, stream):
    """Run a library's C entry point (from ``load``) on inputs ``ssd_cuda``
    has checked, on the stream handle ``stream``: allocates y, the final
    state and the wgmma route's scratch beside x and returns (route, y,
    state).  Raises if the entry reports an error.  Counts nothing."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    route = ssd_route(x, B, C, chunk)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return route, y, state
    scratch = None
    if route == "wgmma":   # per (batch, head): each chunk's state and decay, cums and dt
        scratch = torch.empty((b * h * ((s // chunk) * (p * n + 1) + 3 * s),),
                              dtype=torch.float32, device=x.device)
    err = entry(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                y.data_ptr(), state.data_ptr(), None if scratch is None else scratch.data_ptr(),
                ROUTES.index(route),
                _DTYPE_CODE[x.dtype], b, s, h, p, g, n, chunk, *x.stride(), *dt.stride(),
                A.stride(0), *B.stride(), *C.stride(), *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd ({route} route) launch failed (CUDA error {err})")
    return route, y, state


def _check(x, dt, A, B, C, chunk, name):
    """Validate the forward's inputs for the kernels, on any device."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x/B/C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 dt and A, got {dt.dtype}, {A.dtype}")
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, g, n) or tuple(C.shape) != (b, s, g, n)
            or g == 0 or h % g):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"{name} covers head dim p <= {MAX_P}, state n <= {MAX_N} and "
                         f"1 <= chunk <= {MAX_CHUNK}, got p={p}, n={n}, chunk={chunk}")
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}: pad it upstream")


def _check_device(ts, name):
    if any(t is not None and (t.device.type != "cuda" or t.device != ts[0].device) for t in ts):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts if t is not None]}")


def ssd_cuda(x, dt, A, B, C, *, chunk=256):
    """x: (b, s, h, p); dt: (b, s, h) float32, post-softplus; A: (h,) float32;
    B, C: (b, s, g, n) with h % g == 0; x, B, C float32 or bfloat16 of one
    dtype, on one CUDA device, any strides.  ``s % chunk == 0``, p <= 64,
    n <= 128, 1 <= chunk <= 1024.  Returns (y: (b, s, h, p) in x.dtype,
    final_state: (b, h, p, n) float32), the state starting at 0.

    Adds one to ``ssd_cuda.launches`` per call, whatever number of CUDA
    kernels its route runs, and one to ``ssd_cuda.routes[ssd_route(...)]``.
    Inputs that require grad are taken, but the outputs carry no graph:
    :func:`ssd` differentiates it through :func:`ssd_bwd_cuda`."""
    _check_device((x, dt, A, B, C), "ssd_cuda")
    _check(x, dt, A, B, C, chunk, "ssd_cuda")
    with torch.cuda.device(x.device):
        route, y, state = launch(_entry(), x, dt, A, B, C, chunk,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    ssd_cuda.launches += 1
    ssd_cuda.routes[route] += 1
    return y, state


ssd_cuda.launches = 0
ssd_cuda.routes = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------- backward

def build_bwd() -> Path:
    """Compile the backward kernel into ``build/`` unless it is there already."""
    return _build.build(BWD_SRC)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    return load_bwd(build_bwd())


def load_bwd(lib: Path):
    """The C entry point of a library built from ``ssd_scan_bwd.cu``."""
    fn = ctypes.CDLL(str(lib)).ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 20 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_bwd(entry, x, dt, A, B, C, dy, dstate, chunk, stream, route=None):
    """Run a backward library's C entry point (from ``load_bwd``) wherever
    the tensors lie, on the stream handle ``stream``: checks them (all but
    the device), allocates the gradients, their fp32 accumulators and the
    scratch beside x and returns (dx, ddt, dA, dB, dC).  ``dstate`` is the
    final state's gradient or None (0).  ``route`` None takes
    ``ssd_bwd_route``'s choice; "fma" or "wgmma" asks for that route (the
    entry refuses a wgmma call it cannot take).  Raises if the entry reports
    an error.  Counts nothing."""
    _check(x, dt, A, B, C, chunk, "ssd_bwd_cuda")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dy.shape) != (b, s, h, p) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be shaped and typed as x {(b, s, h, p)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dstate is not None:
        if tuple(dstate.shape) != (b, h, p, n) or dstate.dtype != torch.float32:
            raise ValueError(f"the final state's gradient must be float32 {(b, h, p, n)}, "
                             f"got {tuple(dstate.shape)} {dstate.dtype}")
        dstate = dstate.contiguous()
    route = ssd_bwd_route(x, B, C, dy, chunk) if route is None else route
    f32, dev = torch.float32, x.device
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)   # every row is written
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA = torch.zeros((h,), dtype=f32, device=dev)
    acc = torch.zeros((2, b, s, g, n), dtype=f32, device=dev)   # dB, dC summed over the group
    out = acc if x.dtype == f32 else torch.empty((2, b, s, g, n), dtype=x.dtype, device=dev)
    # per (batch, head): each chunk's S0 and dS1 and its decay; the wgmma
    # route also gathers dc, one float a step
    per = (s // chunk) * (2 * p * n + 1) + (s if route == "wgmma" else 0)
    scratch = torch.empty((max(1, b * h * per),), dtype=f32, device=dev)
    err = entry(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), acc[0].data_ptr(),
                acc[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(), scratch.data_ptr(),
                ROUTES.index(route), _DTYPE_CODE[x.dtype], b, s, h, p, g, n, chunk,
                *x.stride(), *dt.stride(), A.stride(0), *B.stride(), *C.stride(), *dy.stride(),
                stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd ({route} route) launch failed (CUDA error {err})")
    return dx, ddt, dA, out[0], out[1]


def ssd_bwd_cuda(x, dt, A, B, C, dy, dstate=None, *, chunk=256):
    """Gradients (dx, ddt, dA, dB, dC) of ``ssd_cuda`` at (x, dt, A, B, C),
    given the output's gradient ``dy`` (shaped and typed as x, any strides)
    and the final state's ``dstate`` ((b, h, p, n) float32) or None when the
    state is unused.  dx, dB and dC come in x's dtype, ddt and dA in
    float32; dB and dC sum over the heads of each group, dA over every
    (batch, step), in fp32 atomics, and ddt's dc on the wgmma route too
    (their last bits vary from run to run; dx's do not).  The same inputs
    as ``ssd_cuda`` (any strides), on one CUDA device; the route is
    ``ssd_bwd_route``'s choice, never the caller's.

    Adds one to ``ssd_bwd_cuda.launches`` per call (four CUDA kernels on the
    wgmma route, three on the fma route, and for bfloat16 two casts) and one
    to ``ssd_bwd_cuda.routes[ssd_bwd_route(...)]``."""
    _check_device((x, dt, A, B, C, dy, dstate), "ssd_bwd_cuda")
    route = ssd_bwd_route(x, B, C, dy, chunk)
    with torch.cuda.device(x.device):
        grads = launch_bwd(_bwd_entry(), x, dt, A, B, C, dy, dstate, chunk,
                           torch.cuda.current_stream(x.device).cuda_stream, route)
    ssd_bwd_cuda.launches += 1
    ssd_bwd_cuda.routes[route] += 1
    return grads


ssd_bwd_cuda.launches = 0
ssd_bwd_cuda.routes = dict.fromkeys(ROUTES, 0)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state = ssd_cuda(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused final state has no gradient
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:                     # only the final state was used
            dy = torch.zeros_like(x)
        elif ssd_route(x, B, C, ctx.chunk) == "wgmma" and not _aligned(dy):
            dy = dy.contiguous()           # the wgmma route reads dy's rows as x's
        return (*ssd_bwd_cuda(x, dt, A, B, C, dy, dstate, chunk=ctx.chunk), None)


def ssd(x, dt, A, B, C, *, chunk=256):
    """``ssd_cuda`` with its gradient through ``ssd_bwd_cuda``: only when
    autograd records (grad mode on and an input that requires grad) does
    the call go through the autograd ``Function``; otherwise it is the
    serving kernel as it is."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        return _SSD.apply(x, dt, A, B, C, chunk)
    return ssd_cuda(x, dt, A, B, C, chunk=chunk)
