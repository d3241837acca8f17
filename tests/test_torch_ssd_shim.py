"""K3's CUDA source, both routes, built with g++ against a CPU emulation of
CUDA and of ``csrc/hopper.cuh`` (``tests/cuda_shim``, built by its
``emulate.py``) and held against the plain ``ssd_ref`` on CPU tensors: the
indexing, the 128-byte swizzle, the wgmma descriptors (K-major and MN-major A and B, A from registers), the
chunk-parallel split and the hi/lo precision plan run as the card runs
them, only slowly.  What the emulation cannot show is whether the card
reads descriptors this way, nor speed: the card tests in
``test_torch_ssd.py`` do that.

Tolerances as there: y 2e-3 (f32) / 2e-2 (bf16), state 2e-3, all
·(1+|ref|).  Shapes stay at a few hundred rows: the emulation runs one
thread per CUDA thread and the blocks one after another."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cuda_shim import emulate
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    # one directory per session: workers share nothing
    return ssd.load(emulate.build(ssd.SRC, tmp_path_factory.mktemp("shim")))


def _close(got, want, tol):
    """|got - want| <= tol·(1+|want|)."""
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)


CASES = [  # (b, s, h, p, g, n, chunk, dtype, layout, A scale)
    (1, 128, 2, 64, 1, 128, 64, "bfloat16", "contiguous", 1.0),
    (1, 256, 2, 64, 1, 128, 128, "bfloat16", "contiguous", 1.0),
    (1, 256, 2, 64, 2, 128, 128, "bfloat16", "contiguous", 1.0),
    (1, 192, 1, 64, 1, 48, 64, "bfloat16", "contiguous", 1.0),
    (1, 256, 1, 64, 1, 96, 256, "bfloat16", "contiguous", 1.0),
    (1, 256, 3, 64, 1, 128, 128, "bfloat16", "projection", 1.0),
    (1, 256, 2, 64, 1, 128, 128, "bfloat16", "contiguous", 8.0),
    (1, 64, 2, 16, 2, 16, 16, "float32", "contiguous", 1.0),
    (1, 64, 2, 16, 2, 16, 16, "bfloat16", "contiguous", 1.0),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,layout,scale", CASES)
def test_emulated_kernel_matches_plain(entry, b, s, h, p, g, n, chunk, dtype, layout, scale):
    rng = np.random.default_rng(0)
    normal = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    cdt = getattr(torch, dtype)
    if layout == "projection":   # views of one projection row, as ssm_forward hands them over
        xbc = normal(b, s, h * p + 2 * g * n).to(cdt)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        x, B, C = normal(b, s, h, p).to(cdt), normal(b, s, g, n).to(cdt), normal(b, s, g, n).to(cdt)
    dt = F.softplus(normal(b, s, h))
    A = -normal(h).exp() * scale
    route, y, st = ssd.launch(entry, x, dt, A, B, C, chunk, None)   # the shim has no streams
    assert route == ("wgmma" if dtype == "bfloat16" and p == 64 else "fma")
    wy, wst = ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    _close(y, wy, TOL[dtype])
    _close(st, wst, TOL["float32"])
