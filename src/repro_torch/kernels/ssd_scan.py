"""Mamba-2 SSD chunked scan (forward) as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.ssd_scan.ssd_pallas``; the kernels are in
``repro_torch/csrc/ssd_scan.cu`` (design and bound in its header).
``repro_torch.kernels._build`` compiles it with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface at first use, under ``build/`` at
the root of the checkout; it is called through ``ctypes``.  ``ssd_route``
picks one of its two routes before launch: the chunk-parallel ``wgmma``
kernels for the main path's bf16 case, the ``fma`` kernel for the rest.

The plain version of the same function is
``repro_torch.kernels.ref.ssd_ref``; ``repro_torch.kernels.ops`` sends CPU
tensors there and CUDA tensors here.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SRC = _build.CSRC / "ssd_scan.cu"
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
    for t in (x, B, C):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            return "fma"
    return "wgmma"


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


def ssd_cuda(x, dt, A, B, C, *, chunk=256):
    """x: (b, s, h, p); dt: (b, s, h) float32, post-softplus; A: (h,) float32;
    B, C: (b, s, g, n) with h % g == 0; x, B, C float32 or bfloat16 of one
    dtype, on one CUDA device, any strides.  ``s % chunk == 0``, p <= 64,
    n <= 128, 1 <= chunk <= 1024.  Returns (y: (b, s, h, p) in x.dtype,
    final_state: (b, h, p, n) float32), the state starting at 0.

    Adds one to ``ssd_cuda.launches`` per call, whatever number of CUDA
    kernels its route runs, and one to ``ssd_cuda.routes[ssd_route(...)]``.
    Forward only: inputs that require grad are refused."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if any(t.device != x.device for t in (dt, A, B, C)) or x.device.type != "cuda":
        raise ValueError(f"ssd_cuda needs x, dt, A, B, C on one CUDA device, got "
                         f"{[str(t.device) for t in (x, dt, A, B, C)]}")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_cuda takes float32 or bfloat16 x/B/C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_cuda takes float32 dt and A, got {dt.dtype}, {A.dtype}")
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, s, g, n) or tuple(C.shape) != (b, s, g, n)
            or g == 0 or h % g):
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_cuda covers head dim p <= {MAX_P}, state n <= {MAX_N} and "
                         f"1 <= chunk <= {MAX_CHUNK}, got p={p}, n={n}, chunk={chunk}")
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}: pad it upstream")
    if any(t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError("ssd_cuda is forward-only (the JAX package has no "
                                  "SSD backward kernel either)")
    with torch.cuda.device(x.device):
        route, y, state = launch(_entry(), x, dt, A, B, C, chunk,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    ssd_cuda.launches += 1
    ssd_cuda.routes[route] += 1
    return y, state


ssd_cuda.launches = 0
ssd_cuda.routes = dict.fromkeys(ROUTES, 0)
