"""K3, the SSD scan: the port's CPU path of ``ops.ssd`` against the Pallas
kernel (interpret mode) and the JAX oracle over the sweep of
``tests/test_kernels.py``, the port's ``ssd_ref``/``ssd_decode_ref``
against JAX's, the port's ``ssd_ref`` gradients against ``jax.grad`` of
JAX's, the kernel's and its backward's route choice and the forward's
wgmma route's precision plan emulated in plain torch, and, on a CUDA card,
the hand-written kernel against its plain version on the route each case
names, and its backward (``ssd_bwd_cuda``, ``ops.ssd`` under autograd)
against ``ssd_bwd_ref``, on the wgmma route at mamba2-780m's train shape.

Tolerances: 2e-3 for float32 y and state, as the JAX suite holds K3
(``tests/test_kernels.py:49-50``); 2e-2 for y from bfloat16 x/B/C (one
bfloat16 rounding of y, whose sums run in another order); 1e-5 for the
one-step recurrence (a handful of float32 products).  Gradients: the same
2e-3 / 2e-2 of 1+|ref|, but dA, a sum over every (batch, step) whose terms
cancel, by ||d|| / ||ref|| <= 1e-3 (float32) / 1e-2 (bfloat16) on the card
(the CPU checks against JAX hold it per element too).

JAX is imported inside the ``jx`` fixture, not at the top: the kernel
tests need none, and on the card they run alone
(``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ssd.py -k card``)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_bwd_cuda, ssd_bwd_route, ssd_cuda, ssd_route

SWEEP = [
    (1, 32, 2, 8, 1, 8, 8),
    (2, 64, 4, 16, 2, 16, 16),
    (1, 128, 4, 32, 1, 32, 32),
]
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
DA_REL = {"float32": 1e-3, "bfloat16": 1e-2}


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


GRAD_CASES = [  # (b, s, h, p, g, n, chunk, initial state)
    (2, 32, 2, 8, 1, 8, 16, False),      # g 1, rep 2, two chunks of 16
    (1, 64, 4, 16, 2, 16, 16, True),     # g 2, rep 2, from a given state
    (2, 128, 6, 8, 2, 16, 64, False),    # g 2, rep 3, chunk 64
    (1, 128, 4, 16, 1, 32, 64, True),    # rep 4, chunk 64, from a given state
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", GRAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ref_gradients_match_jax_grad(jx, b, s, h, p, g, n, chunk, init, dtype):
    """dx, ddt, dA, dB, dC (and d(initial state) where one is given) of the
    port's ``ssd_ref`` by autograd against ``jax.grad`` of JAX's, the same
    numpy inputs and output gradients (dy, and a d(final state)) on both
    sides: the plain version of the backward kernel (``ssd_bwd_ref``).  In
    bfloat16, x, B, C and dy are rounded to bfloat16 and both sides
    differentiate in float32 (both ``ssd_ref``s promote x, B and C before
    any product) and cast each gradient once, as the kernel does: through
    bfloat16 leaves each framework rounds every head's dB and dC before the
    sum over its group, at other places, and a flip at a cancelling sum
    shows up to 0.11 apart at rep 3."""
    import jax
    rng = np.random.default_rng(10)
    arrs = list(_inputs(b, s, h, p, g, n, seed=11))
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dfin = rng.normal(size=(b, h, p, n)).astype(np.float32)
    if init:
        arrs.append(rng.normal(size=(b, h, p, n)).astype(np.float32))
    for i in (0, 3, 4):   # the bfloat16 values, held in float32
        arrs[i] = torch.from_numpy(arrs[i]).to(getattr(torch, dtype)).float().numpy()
    dy = torch.from_numpy(dy).to(getattr(torch, dtype)).float().numpy()
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, st = tref.ssd_ref(*leaves[:5], chunk=chunk, initial_state=leaves[5] if init else None)
    got = torch.autograd.grad((y, st), leaves, (torch.from_numpy(dy), torch.from_numpy(dfin)))
    jnp = jx.jnp

    def loss(*args):
        jy, jst = jx.ref.ssd_ref(*args[:5], chunk=chunk,
                                 initial_state=args[5] if init else None)
        return (jy * jnp.asarray(dy)).sum() + (jst * jnp.asarray(dfin)).sum()

    want = jax.grad(loss, argnums=tuple(range(len(arrs))))(*(jnp.asarray(a) for a in arrs))
    cast = {0: dtype, 3: dtype, 4: dtype}   # dx, dB, dC in the inputs' dtype
    for i, (name, g_, w) in enumerate(zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got, want)):
        g_ = g_.to(getattr(torch, cast.get(i, "float32")))
        w = np.asarray(jnp.asarray(w).astype(cast.get(i, "float32")), np.float32)
        _close(_f32(g_), w, TOL[dtype])
    rel = float(np.linalg.norm(_f32(got[2]) - np.asarray(want[2], np.float32))
                / np.linalg.norm(np.asarray(want[2], np.float32)))
    assert rel <= DA_REL[dtype], rel


def test_ssd_bwd_ref_is_autograd_in_float32():
    """``ssd_bwd_ref``: autograd through ``ssd_ref`` with the gradient in
    float32, cast to each input's dtype at the end; for float32 inputs,
    exactly autograd through ``ssd_ref``."""
    b, s, h, p, g, n, chunk = 1, 32, 4, 8, 2, 8, 16
    rng = np.random.default_rng(12)
    dy = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32))
    dfin = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(np.float32))
    args = [t.requires_grad_() for t in _torch(_inputs(b, s, h, p, g, n, seed=13))]
    y, st = tref.ssd_ref(*args, chunk=chunk)
    want = torch.autograd.grad((y, st), args, (dy, dfin))
    got = tref.ssd_bwd_ref(*args, dy, dfin, chunk=chunk)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=0, atol=0)
    bf = _torch(_inputs(b, s, h, p, g, n, seed=13), "bfloat16")
    got = tref.ssd_bwd_ref(*bf, dy.bfloat16(), chunk=chunk)
    assert [t.dtype for t in got] == [t.dtype for t in bf]


def test_cpu_path_differentiates_the_plain_version():
    """``ops.ssd`` on CPU tensors under autograd is ``ssd_ref``'s graph: the
    card's kernels are not reached."""
    args = [t.requires_grad_() for t in _torch(_inputs(1, 32, 2, 8, 1, 8, seed=14))]
    before = (ssd_cuda.launches, ssd_bwd_cuda.launches)
    y, _ = ops.ssd(*args, chunk=16)
    got = torch.autograd.grad(y.square().sum(), args)
    want = torch.autograd.grad(tref.ssd_ref(*args, chunk=16)[0].square().sum(), args)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=0, atol=0)
    assert (ssd_cuda.launches, ssd_bwd_cuda.launches) == before


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
    args = _torch(_inputs(1, 32, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd_cuda(*args, torch.zeros((1, 32, 2, 8)), chunk=8)


def _projection_views(b, s, h, p, g, n, dtype=torch.bfloat16, offset=0, device="cpu"):
    """x, B and C as ``ssm_forward`` hands them over: views of one
    (b, s, offset + h p + 2 g n) projection row (3328 wide for mamba2-780m),
    starting ``offset`` elements in."""
    rng = np.random.default_rng(6)
    width = offset + h * p + 2 * g * n
    xbc = torch.from_numpy(rng.normal(size=(b, s, width)).astype(np.float32)).to(device, dtype)
    x = xbc[..., offset:offset + h * p].reshape(b, s, h, p)
    B = xbc[..., offset + h * p:offset + h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., offset + h * p + g * n:].reshape(b, s, g, n)
    return x, B, C


def _contiguous(b, s, h, p, g, n, dtype=torch.bfloat16):
    return (torch.zeros((b, s, h, p), dtype=dtype), torch.zeros((b, s, g, n), dtype=dtype),
            torch.zeros((b, s, g, n), dtype=dtype))


ROUTE_CASES = [
    ("views of one 3328-wide projection, chunk 64", lambda: _projection_views(1, 64, 48, 64, 1, 128), 64, "wgmma"),
    ("views of one 3328-wide projection, chunk 256", lambda: _projection_views(1, 256, 48, 64, 1, 128), 256, "wgmma"),
    ("views of hymba's 3232-wide projection, n=16", lambda: _projection_views(1, 256, 50, 64, 1, 16), 256, "wgmma"),
    ("contiguous, g=2, n=64", lambda: _contiguous(2, 128, 8, 64, 2, 64), 128, "wgmma"),
    ("float32", lambda: _contiguous(1, 256, 4, 64, 1, 128, torch.float32), 256, "fma"),
    ("chunk 1 (the one-token prefill)", lambda: _projection_views(1, 1, 48, 64, 1, 128), 1, "fma"),
    ("chunk 100", lambda: _contiguous(1, 200, 4, 64, 1, 128), 100, "fma"),
    ("p=24", lambda: _contiguous(1, 130, 3, 24, 3, 40, torch.bfloat16), 65, "fma"),
    ("n=40", lambda: _contiguous(1, 128, 2, 64, 1, 40), 64, "fma"),
    ("p=24 at chunk 64", lambda: _contiguous(1, 128, 3, 24, 1, 128), 64, "fma"),
    ("rows not 16-byte aligned", lambda: _projection_views(1, 64, 4, 64, 1, 128, offset=4), 64, "fma"),
    ("last dim strided", lambda: tuple(t.transpose(2, 3) for t in _contiguous(1, 64, 64, 2, 128, 1)), 64, "fma"),
]


@pytest.mark.parametrize("what,make,chunk,route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_is_chosen_from_dtype_shape_and_layout(what, make, chunk, route):
    """The wgmma route takes the main path's bf16 case, p = 64, n a multiple
    of 16 up to 128, chunk a multiple of 64, read through its views as they
    are; everything else keeps the fma kernel."""
    x, B, C = make()
    assert ssd_route(x, B, C, chunk) == route


def _dy_view(x, offset=0, extra=0):
    """dy shaped as x, a view of a (b, s, offset + h p + extra) buffer."""
    b, s, h, p = x.shape
    buf = torch.zeros((b, s, offset + h * p + extra), dtype=x.dtype)
    return buf[..., offset:offset + h * p].unflatten(2, (h, p))


def _mamba2_views():
    return _projection_views(1, 64, 48, 64, 1, 128)


# (what, x/B/C, dy from x, chunk, route): the forward's cases with dy
# contiguous and typed as x, then dy's own layouts beside x, B, C the
# wgmma route takes
BWD_ROUTE_CASES = [(what, make, torch.zeros_like, chunk, route)
                   for what, make, chunk, route in ROUTE_CASES] + [
    ("dy a view of a wider row, 16-byte aligned", _mamba2_views, lambda x: _dy_view(x, 0, 64), 64, "wgmma"),
    ("dy rows not 16-byte aligned", _mamba2_views, lambda x: _dy_view(x, 4), 64, "fma"),
    ("dy last dim strided", _mamba2_views,
     lambda x: torch.zeros_like(x).transpose(1, 3).contiguous().transpose(1, 3), 64, "fma"),
    ("dy float32 beside bf16 x", _mamba2_views, lambda x: torch.zeros(x.shape), 64, "fma"),
]


@pytest.mark.parametrize("what,make,make_dy,chunk,route", BWD_ROUTE_CASES,
                         ids=[c[0] for c in BWD_ROUTE_CASES])
def test_bwd_route_is_chosen_from_dtype_shape_and_layout(what, make, make_dy, chunk, route):
    """The backward takes the forward's route (wgmma for bf16, p 64, n a
    multiple of 16 up to 128, chunk a multiple of 64 and aligned x, B, C;
    fma otherwise) when dy is bf16 with a contiguous last dim and 16-byte
    aligned rows, as x is; fma when it is not."""
    x, B, C = make()
    assert ssd_bwd_route(x, B, C, make_dy(x), chunk) == route


def test_bench_ssd_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.launch import bench_ssd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        bench_ssd.main([])


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_profile_train_takes_the_ssm_archs_and_refuses_without_a_card(monkeypatch, arch):
    """``profile_train --arch`` trains the SSM and hybrid families too (K3
    and its backward among its kernels); it measures the card only."""
    from repro_torch.launch import profile_train
    assert arch in profile_train.ARCHS and {"k3", "k3b"} <= set(profile_train.KERNELS)
    assert profile_train.KERNELS["k3b"] is ssd_bwd_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_train.main(["--arch", arch])


def _terms(v, split):
    """An fp32 operand as the wgmma route feeds it to the tensor cores: hi =
    bf16(v) and lo = bf16(v - hi) (``split``), or hi alone."""
    hi = v.to(torch.bfloat16).float()
    return (hi, (v - hi).to(torch.bfloat16).float()) if split else (hi,)


def _emulate_wgmma_route(x, dt, A, B, C, chunk, split):
    """The wgmma route's arithmetic in plain torch: bf16 x/B/C exact, each
    fp32 operand of a product as bf16 terms, every product summed in fp32;
    the chunk states, the carry across chunks, then the outputs.  cums in
    fp64 and L masked before the exp, per element, as the kernel does."""
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    nc, Q = s // chunk, chunk
    xf = x.float().reshape(b, nc, Q, h, p)
    Bf = B.float().repeat_interleave(h // g, dim=2).reshape(b, nc, Q, h, n)
    Cf = C.float().repeat_interleave(h // g, dim=2).reshape(b, nc, Q, h, n)
    dtc = dt.reshape(b, nc, Q, h)
    cums = torch.cumsum((dt * A).double().reshape(b, nc, Q, h), dim=2)
    total = cums[:, :, -1]                                              # (b, nc, h)
    w = dtc * torch.exp((total[:, :, None] - cums).float())
    U = sum(torch.einsum("bcjhp,bcjhn->bchpn", t, Bf) for t in _terms(xf * w[..., None], split))
    S, prev = torch.zeros((b, h, p, n)), []
    for c in range(nc):
        prev.append(S)
        S = S * torch.exp(total[:, c].float())[..., None, None] + U[:, c]
    prev = torch.stack(prev, 1)                                         # (b, nc, h, p, n)
    G = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    diff = cums.permute(0, 1, 3, 2)[..., :, None] - cums.permute(0, 1, 3, 2)[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(diff.masked_fill(~tri, -float("inf")).float())
    score = G * L * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = sum(torch.einsum("bchij,bcjhp->bcihp", t, xf) for t in _terms(score, split))
    inter = sum(torch.einsum("bcihn,bchpn->bcihp", Cf, t) for t in _terms(prev, split))
    y = y + inter * torch.exp(cums.float())[..., None]
    return y.reshape(b, s, h, p).to(x.dtype), S


def test_wgmma_precision_plan_holds_the_tolerances():
    """Two bf16 terms per fp32 operand keep the wgmma route within the
    tolerances of ``ssd_ref`` (y 2e-2, state 2e-3, both ·(1+|ref|)) at the
    serving chunk, with fast-decaying heads (|cums| in the hundreds within
    a chunk); one term each errs more, the state by about the tolerance."""
    b, s, h, p, g, n, chunk = 1, 512, 2, 64, 1, 128, 256
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n, seed=7), "bfloat16")
    A = torch.tensor([-0.5, -8.0])                       # a slow and a fast head
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    assert float((dt * A).sum(1).min()) < -500           # the fast head's cums
    errs = {}
    for split in (True, False):
        y, st = _emulate_wgmma_route(x, dt, A, B, C, chunk, split)
        errs[split] = (float(((y.float() - wy.float()).abs() / (1 + wy.float().abs())).max()),
                       float(((st - wst).abs() / (1 + wst.abs())).max()))
    print(f"max |d|/(1+|ref|): two terms y {errs[True][0]:.3e} state {errs[True][1]:.3e}; "
          f"one term y {errs[False][0]:.3e} state {errs[False][1]:.3e}")
    assert errs[True][0] <= TOL["bfloat16"] and errs[True][1] <= TOL["float32"]
    assert errs[False][1] > 10 * errs[True][1]


# ----------------------------------------------------------- on the card

CARD_CASES = [(*shape, dtype) for shape in SWEEP + [
    (1, 3, 2, 16, 1, 16, 1),          # chunk 1: a one-token prefill
    (1, 64, 48, 64, 1, 128, 64),      # the decode phase's forward, full width
    (1, 200, 4, 64, 1, 128, 100),     # chunk 100: ragged 64-row sub-tiles
    (2, 512, 4, 64, 1, 128, 256),     # chunk 256: the serving chunk
    (1, 130, 3, 24, 3, 40, 65),       # odd p, n and group count
] for dtype in ("float32", "bfloat16")]


def _want_route(p, n, chunk, dtype):
    """The route each card case must take (``ssd_route``'s rule, restated)."""
    return "wgmma" if dtype == "bfloat16" and p == 64 and n % 16 == 0 and chunk % 64 == 0 else "fma"


def _run_on_route(route, *args, chunk):
    """ssd_cuda, checking that it took ``route`` with one launch."""
    before, on_route = ssd_cuda.launches, ssd_cuda.routes[route]
    y, st = ssd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1 and ssd_cuda.routes[route] == on_route + 1
    return y, st


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n), dtype, cuda)
    y, st = _run_on_route(_want_route(p, n, chunk, dtype), x, dt, A, B, C, chunk=chunk)
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and bool(torch.isfinite(y.float()).all())
    _close(_f32(y), _f32(wy), TOL[dtype])
    _close(_f32(st), _f32(wst), TOL["float32"])


# the wgmma route: the serving shape (mamba2-780m prefill, batch 4), two
# groups of four heads, fast-decaying heads at the serving chunk, and
# hymba-1.5b's state 16 over its 50 heads (the route's loops at their least)
WGMMA_CASES = [(4, 2048, 48, 64, 1, 128, 256, 1.0), (2, 512, 8, 64, 2, 128, 256, 1.0),
               (1, 1024, 4, 64, 1, 64, 128, 16.0), (2, 512, 50, 64, 1, 16, 256, 1.0)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,decay", WGMMA_CASES)
def test_wgmma_route_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, decay):
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n, seed=8), "bfloat16", cuda)
    A = A * decay
    y, st = _run_on_route("wgmma", x, dt, A, B, C, chunk=chunk)
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    assert bool(torch.isfinite(y.float()).all())
    _close(_f32(y), _f32(wy), TOL["bfloat16"])
    _close(_f32(st), _f32(wst), TOL["float32"])


@pytest.mark.parametrize("h,n,width", [(48, 128, 3328), (50, 16, 3232)])
def test_wgmma_route_reads_projection_views_on_card(cuda, h, n, width):
    """Full-width x, B and C as views of one (b, s, width) projection, as
    the ``ssm_forward`` of mamba2-780m (3328) and of hymba-1.5b (3232)
    hands them over, at chunk 256: read in place, no copy."""
    b, s, p, g = 2, 512, 64, 1
    x, B, C = _projection_views(b, s, h, p, g, n, device=cuda)
    assert x.stride(1) == B.stride(1) == C.stride(1) == width
    _, dt, A, _, _ = _torch(_inputs(b, s, h, p, g, n), "float32", cuda)
    y, st = _run_on_route("wgmma", x, dt, A, B, C, chunk=256)
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=256)
    _close(_f32(y), _f32(wy), TOL["bfloat16"])
    _close(_f32(st), _f32(wst), TOL["float32"])


def test_wgmma_route_is_deterministic_on_card(cuda):
    """No atomics on the wgmma route: two runs give the same bits."""
    x, dt, A, B, C = _torch(_inputs(2, 1024, 8, 64, 1, 128, seed=9), "bfloat16", cuda)
    (y1, s1), (y2, s2) = (_run_on_route("wgmma", x, dt, A, B, C, chunk=256) for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_kernel_reads_strided_views_on_card(cuda):
    """x, B and C sliced out of one projection, as ``ssm_forward`` does."""
    b, s, h, p, n = 2, 64, 4, 16, 16
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * n)).astype(np.float32)).to(cuda)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xbc[..., h * p + n:].reshape(b, s, 1, n)
    _, dt, A, _, _ = _torch(_inputs(b, s, h, p, 1, n), "float32", cuda)
    y, st = _run_on_route("fma", x, dt, A, B, C, chunk=16)
    wy, wst = tref.ssd_ref(x, dt, A, B, C, chunk=16)
    _close(_f32(y), _f32(wy), TOL["float32"])
    _close(_f32(st), _f32(wst), TOL["float32"])


def test_kernel_refuses_grad_and_unsupported_sizes_on_card(cuda):
    """The sizes the kernels do not cover are refused, forward and
    backward; inputs that require grad are taken, and ``ops.ssd``
    differentiates through the backward kernel."""
    x, dt, A, B, C = _torch(_inputs(1, 32, 2, 8, 1, 8), "float32", cuda)
    args = [t.requires_grad_() for t in (x, dt, A, B, C)]
    before = ssd_bwd_cuda.launches
    y, _ = ops.ssd(*args, chunk=8)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, args, dy)
    assert ssd_bwd_cuda.launches == before + 1
    for g_, w in zip(got, tref.ssd_bwd_ref(*args, dy, chunk=8)):
        _close(_f32(g_), _f32(w), TOL["float32"])
    x, dt, A, B, C = _torch(_inputs(1, 32, 2, 128, 1, 8), "float32", cuda)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd_cuda(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd_bwd_cuda(x, dt, A, B, C, torch.zeros_like(x), chunk=8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_cuda(*_torch(_inputs(1, 20, 2, 8, 1, 8), "float32", cuda), chunk=8)


BWD_CARD_CASES = [(*shape, dtype, final) for shape in SWEEP + [
    (1, 3, 2, 16, 1, 16, 1),          # chunk 1
    (2, 512, 8, 64, 2, 128, 256),     # two groups at the serving chunk
    (1, 200, 4, 64, 1, 128, 100),     # chunk 100: ragged 64-row tiles
    (2, 512, 50, 64, 1, 16, 256),     # hymba-1.5b's state 16 over its 50 heads
    (1, 130, 3, 24, 3, 40, 65),       # odd p, n and group count
] for dtype in ("float32", "bfloat16") for final in (False, True)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,final", BWD_CARD_CASES)
def test_backward_matches_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype, final):
    x, dt, A, B, C = _torch(_inputs(b, s, h, p, g, n), dtype, cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    dy = torch.randn((b, s, h, p), generator=gen, device=cuda).to(x.dtype)
    dfin = torch.randn((b, h, p, n), generator=gen, device=cuda) if final else None
    got = ssd_bwd_cuda(x, dt, A, B, C, dy, dfin, chunk=chunk)
    torch.cuda.synchronize()
    want = tref.ssd_bwd_ref(x, dt, A, B, C, dy, dfin, chunk=chunk)
    for i, (g_, w) in enumerate(zip(got, want)):
        assert g_.dtype == w.dtype and bool(torch.isfinite(g_.float()).all())
        if i != 2:   # dA, a sum over every (batch, step), by its error norm
            _close(_f32(g_), _f32(w), TOL[dtype])
    assert float((got[2] - want[2]).norm() / want[2].norm()) <= DA_REL[dtype]


def test_wgmma_bwd_route_at_mamba2_train_shape_on_card(cuda):
    """mamba2-780m's train shape (b 4, s 2048, 48 heads, n 128, chunk 256;
    x, B and C the views of one 3328-wide row): the backward takes the wgmma
    route, matches ``ssd_bwd_ref``, and gives bit-equal dx over two runs
    (dx has no atomics; ddt, dA, dB and dC sum with them)."""
    b, s, h, p, g, n, chunk = 4, 2048, 48, 64, 1, 128, 256
    x, B, C = _projection_views(b, s, h, p, g, n, device=cuda)
    _, dt, A, _, _ = _torch(_inputs(b, s, h, p, g, n, seed=10), "float32", cuda)
    dy = torch.randn((b, s, h, p), generator=torch.Generator(cuda).manual_seed(2),
                     device=cuda).to(torch.bfloat16)
    assert ssd_bwd_route(x, B, C, dy, chunk) == "wgmma"
    before = ssd_bwd_cuda.routes["wgmma"]
    runs = [ssd_bwd_cuda(x, dt, A, B, C, dy, chunk=chunk) for _ in range(2)]
    torch.cuda.synchronize()
    assert ssd_bwd_cuda.routes["wgmma"] == before + 2
    assert torch.equal(runs[0][0], runs[1][0])
    want = tref.ssd_bwd_ref(x, dt, A, B, C, dy, chunk=chunk)
    for i, (g_, w) in enumerate(zip(runs[0], want)):
        assert g_.dtype == w.dtype and bool(torch.isfinite(g_.float()).all())
        if i != 2:
            _close(_f32(g_), _f32(w), TOL["bfloat16"])
    assert float((runs[0][2] - want[2]).norm() / want[2].norm()) <= DA_REL["bfloat16"]
