"""K3, the SSD scan: the port's CPU path of ``ops.ssd`` against the Pallas
kernel (interpret mode) and the JAX oracle over the sweep of
``tests/test_kernels.py``, the port's ``ssd_ref``/``ssd_decode_ref``
against JAX's, and, on a CUDA card, the hand-written kernel against its
plain version.

Tolerances: 2e-3 for float32 y and state, as the JAX suite holds K3
(``tests/test_kernels.py:49-50``); 2e-2 for y from bfloat16 x/B/C (one
bfloat16 rounding of y, whose sums run in another order); 1e-5 for the
one-step recurrence (a handful of float32 products).

JAX is imported inside the ``jx`` fixture, not at the top: the kernel
tests need none, and on the card they run alone
(``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ssd.py -k card``)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_cuda

SWEEP = [
    (1, 32, 2, 8, 1, 8, 8),
    (2, 64, 4, 16, 2, 16, 16),
    (1, 128, 4, 32, 1, 32, 32),
]
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_pallas
    return types.SimpleNamespace(jnp=jax.numpy, ref=jref, pallas=ssd_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    return torch.device("cuda")


def _inputs(b, s, h, p, g, n, seed=0):
    """As the JAX test draws them: x, B, C normal; dt = softplus(normal);
    A = -exp(normal).  All float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrs, dtype="float32", device="cpu"):
    """x, B, C in ``dtype``; dt and A stay float32."""
    x, dt, A, B, C = (torch.from_numpy(a).to(device) for a in arrs)
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, A, B.to(dt_), C.to(dt_)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_path_matches_pallas_and_oracle(jx, b, s, h, p, g, n, chunk, dtype):
    arrs = _inputs(b, s, h, p, g, n)
    x, dt, A, B, C = _torch(arrs, dtype)
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    jargs = [jx.jnp.asarray(a) for a in arrs]
    for i in (0, 3, 4):
        jargs[i] = jargs[i].astype(dtype)
    py, pst = jx.pallas(*jargs, chunk=chunk, interpret=True)
    oy, ost = jx.ref.ssd_ref(*jargs, chunk=chunk)
    for want_y, want_st in ((py, pst), (oy, ost)):
        _close(_f32(y), want_y, TOL[dtype])
        _close(_f32(st), want_st, TOL["float32"])


def test_ssd_ref_initial_state_matches_jax_and_splits(jx):
    """From a given state, as JAX's oracle; and two halves carried through
    the state equal the whole sequence."""
    b, s, h, p, g, n = 2, 48, 4, 8, 2, 16
    arrs = _inputs(b, s, h, p, g, n, seed=1)
    init = np.random.default_rng(2).normal(size=(b, h, p, n)).astype(np.float32)
    x, dt, A, B, C = _torch(arrs)
    y, st = tref.ssd_ref(x, dt, A, B, C, chunk=16, initial_state=torch.from_numpy(init))
    wy, wst = jx.ref.ssd_ref(*(jx.jnp.asarray(a) for a in arrs), chunk=16,
                             initial_state=jx.jnp.asarray(init))
    _close(_f32(y), wy, 2e-3)
    _close(_f32(st), wst, 2e-3)
    half = s // 2
    y1, st1 = tref.ssd_ref(x[:, :half], dt[:, :half], A, B[:, :half], C[:, :half], chunk=8)
    y2, st2 = tref.ssd_ref(x[:, half:], dt[:, half:], A, B[:, half:], C[:, half:], chunk=8,
                           initial_state=st1)
    whole, st_whole = tref.ssd_ref(x, dt, A, B, C, chunk=8)
    _close(_f32(torch.cat([y1, y2], 1)), _f32(whole), 2e-4)
    _close(_f32(st2), _f32(st_whole), 2e-4)


def test_ssd_ref_refuses_a_ragged_sequence():
    with pytest.raises(ValueError, match="multiple of chunk"):
        tref.ssd_ref(*_torch(_inputs(1, 20, 2, 8, 1, 8)), chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_ref_matches_jax(jx, dtype):
    rng = np.random.default_rng(3)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, h)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(h,)))).astype(np.float32)
    B, C = (rng.normal(size=(b, g, n)).astype(np.float32) for _ in range(2))
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    dt_ = getattr(torch, dtype)
    y, st = tref.ssd_decode_ref(torch.from_numpy(x).to(dt_), torch.from_numpy(dt),
                                torch.from_numpy(A), torch.from_numpy(B).to(dt_),
                                torch.from_numpy(C).to(dt_), torch.from_numpy(state))
    jnp = jx.jnp
    wy, wst = jx.ref.ssd_decode_ref(jnp.asarray(x).astype(dtype), jnp.asarray(dt),
                                    jnp.asarray(A), jnp.asarray(B).astype(dtype),
                                    jnp.asarray(C).astype(dtype), jnp.asarray(state))
    assert y.dtype == dt_ and st.dtype == torch.float32
    _close(_f32(st), wst, 1e-5)
    _close(_f32(y), wy, 1e-5 if dtype == "float32" else TOL["bfloat16"])


def test_ssd_chunked_equals_sequential_recurrence():
    """The port's chunked SSD is exactly its one-step recurrence."""
    b, s, h, p, g, n = 1, 24, 2, 4, 1, 8
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n, seed=4))
    y, fin = tref.ssd_ref(x, dt, A, B, C, chunk=8)
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        yt, state = tref.ssd_decode_ref(x[:, t], dt[:, t], A, B[:, t], C[:, t], state)
        ys.append(yt)
    _close(_f32(y), _f32(torch.stack(ys, 1)), 2e-4)
    _close(_f32(fin), _f32(state), 2e-4)


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*_torch(_inputs(1, 32, 2, 8, 1, 8)), chunk=8)


# ----------------------------------------------------------- on the card

CARD_CASES = [(*shape, dtype) for shape in SWEEP + [
    (1, 3, 2, 16, 1, 16, 1),          # chunk 1: a one-token prefill
    (1, 64, 48, 64, 1, 128, 64),      # the decode phase's forward, full width
    (1, 200, 4, 64, 1, 128, 100),     # chunk 100: ragged 64-row sub-tiles
    (2, 512, 4, 64, 1, 128, 256),     # chunk 256: the serving chunk
    (1, 130, 3, 24, 3, 40, 65),       # odd p, n and group count
] for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n), dtype, cuda)
    before = ssd_cuda.launches
    y, st = ssd_cuda(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and bool(torch.isfinite(y.float()).all())
    _close(_f32(y), _f32(wy), TOL[dtype])
    _close(_f32(st), _f32(wst), TOL["float32"])


def test_kernel_reads_strided_views_on_card(cuda):
    """x, B and C sliced out of one projection, as ``ssm_forward`` does."""
    b, s, h, p, n = 2, 64, 4, 16, 16
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * n)).astype(np.float32)).to(cuda)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xbc[..., h * p + n:].reshape(b, s, 1, n)
    _, dt, A, _, _ = _torch(_inputs(b, s, h, p, 1, n), "float32", cuda)
    y, st = ssd_cuda(x, dt, A, B, C, chunk=16)
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=16)
    _close(_f32(y), _f32(wy), TOL["float32"])
    _close(_f32(st), _f32(wst), TOL["float32"])


def test_kernel_refuses_grad_and_unsupported_sizes_on_card(cuda):
    x, dt, A, B, C = _torch(_inputs(1, 32, 2, 8, 1, 8), "float32", cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ssd_cuda(x.requires_grad_(), dt, A, B, C, chunk=8)
    x, dt, A, B, C = _torch(_inputs(1, 32, 2, 128, 1, 8), "float32", cuda)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd_cuda(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_cuda(*_torch(_inputs(1, 20, 2, 8, 1, 8), "float32", cuda), chunk=8)
