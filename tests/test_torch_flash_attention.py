"""K1, flash attention: the port's CPU path of ``ops.flash_attention``
against the Pallas kernel (interpret mode) and the JAX oracle over the
sweep of ``tests/test_kernels.py``, its gradient against ``jax.grad`` of
the JAX model's ``blocked_attention`` (what the JAX training path
differentiates), the CPU path at MLA's head dims (q/k 96 or 24, v 64 or
16) against the Pallas kernel, and, on a CUDA card, the hand-written
forward and backward kernels against their plain versions (the backward:
autograd through ``attention_ref``), at those head dims too and with v as
a strided view.

Gradient tolerances: 1e-4 at float32 (sums in another order); on the card
``|d| <= tol·(1+|ref|)`` with 1e-4 at float32 and 2e-2 at bfloat16 (P and
dS are rounded to bfloat16 as operands of the tensor-core products, and
dq/dk/dv once at the end, as the forward's output is).

JAX is imported inside the ``jx`` fixture, not at the top: the kernel
tests need none, and on the card they run alone
(``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flash_attention.py -k card``)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda

SHAPES = [
    (1, 32, 32, 2, 2, 16),
    (2, 64, 64, 4, 2, 32),
    (1, 48, 96, 4, 1, 64),      # MQA + cross-length
]
DTYPES = ["float32", "bfloat16"]
MASKS = [(True, None), (False, None), (True, 24)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# on the card, besides: D=128 with several full 128-row tiles (the bf16
# wgmma kernels take D in {64, 128}), and the decode phase's Sq=1 and Sq=64
# at llama3.2-1b's heads; the gradient also at G=8 and MQA, where many
# query heads add into one kv head's dk/dv and the dQ atomics meet
CARD_SHAPES = SHAPES + [(2, 200, 200, 8, 2, 128), (2, 512, 512, 8, 2, 128),
                        (1, 1, 1, 32, 8, 64), (1, 64, 64, 32, 8, 64)]
GRAD_SHAPES = CARD_SHAPES + [(1, 256, 256, 8, 1, 64), (2, 192, 192, 16, 2, 64)]
CARD_MASKS = MASKS + [(False, 24), (True, 1 << 30)]
# MLA (minicpm3-4b): q/k head dim 96 (nope 64 + rope 32), v 64; SMOKE 24 / 16
MLA_DIMS = [(96, 64), (24, 16)]
# on the card: minicpm3's 40 heads, SMOKE's MQA with Skv != Sq, a ragged
# k tile, head dims that round up to the kernels' widths, and the other
# width pairs the kernels are built for (wgmma 128/64, 64/128, 96/128;
# mma.sync 16/32)
MLA_CARD_SHAPES = [(1, 256, 256, 40, 40, 96, 64), (2, 64, 96, 4, 1, 24, 16),
                   (1, 200, 200, 8, 8, 96, 64), (2, 160, 160, 4, 2, 24, 16),
                   (1, 96, 80, 4, 2, 88, 56), (1, 64, 64, 4, 4, 16, 64),
                   (1, 160, 160, 4, 2, 128, 64), (1, 160, 160, 4, 2, 64, 128),
                   (1, 160, 160, 4, 4, 96, 128), (1, 64, 64, 4, 2, 16, 32)]
# on the card: hymba-1.5b's 25 query heads on 5 kv heads (G = 5) with its
# window of 1024 cutting inside a 128-key tile over 1100 tokens, and the
# decode phase's one-token prefill at those heads
HYMBA_CARD_CASES = [(1, 1100, 1100, 25, 5, 64, 1024), (1, 1, 1, 25, 5, 64, 1024)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_pallas
    return types.SimpleNamespace(jnp=jax.numpy, ref=jref, pallas=flash_attention_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32
    return torch.device("cuda")


def _inputs(B, Sq, Skv, H, KV, D, seed=0, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D if Dv is None else Dv)).astype(np.float32))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_cpu_path_matches_pallas_and_oracle(jx, B, Sq, Skv, H, KV, D, dtype, causal, window):
    arrs = _inputs(B, Sq, Skv, H, KV, D)
    jq, jk, jv = (jx.jnp.asarray(a).astype(dtype) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, D)
    pallas = jx.pallas(jq, jk, jv, causal=causal, window=window, blk_q=16, blk_k=16,
                       interpret=True)
    oracle = jx.ref.attention_ref(jq, jk, jv, causal=causal, window=window or 0)
    _close(_f32(got), pallas, dtype)
    _close(_f32(got), oracle, dtype)


@pytest.mark.parametrize("D,Dv", MLA_DIMS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_cpu_path_matches_pallas_at_mla_head_dims(jx, D, Dv, causal, window):
    """v with its own head dim, as MLA's prefill hands it over: float32,
    within 1e-5 (both sides in float32, sums in another order)."""
    arrs = _inputs(1, 48, 48, 4, 2, D, seed=3, Dv=Dv)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrs), causal=causal,
                              window=window, scale=0.15)
    assert got.shape == (1, 48, 4, Dv)
    want = jx.pallas(*(jx.jnp.asarray(a) for a in arrs), causal=causal, window=window,
                     scale=0.15, blk_q=16, blk_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_head_dims_it_has_no_kernel_for():
    """Head dims above 128 (no config of the repo has one), and bfloat16
    head dims that are not multiples of 8 (rows of 16 bytes), raise before
    any launch; shapes are checked before the device."""
    t = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt)  # noqa: E731
    kw = dict(causal=True, window=0, scale=None, return_lse=False, stream=None)
    for q, k, v in [(t(1, 8, 2, 136), t(1, 8, 2, 136), t(1, 8, 2, 64)),
                    (t(1, 8, 2, 96), t(1, 8, 2, 96), t(1, 8, 2, 192))]:
        with pytest.raises(ValueError, match="head dims 1-128"):
            fa.launch_fwd(None, q, k, v, **kw)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.launch_fwd(None, t(1, 8, 2, 20, dt=bf), t(1, 8, 2, 20, dt=bf), t(1, 8, 2, 16, dt=bf), **kw)
    with pytest.raises(ValueError, match="unsupported shapes"):
        fa.launch_fwd(None, t(1, 8, 2, 96), t(1, 8, 2, 64), t(1, 8, 2, 64), **kw)


@pytest.mark.parametrize("dtype,D,Dv,want", [("float32", 96, 64, "fma"), ("bfloat16", 24, 16, "mma"),
                                             ("bfloat16", 32, 32, "mma"), ("bfloat16", 96, 64, "wgmma"),
                                             ("bfloat16", 16, 64, "wgmma"), ("bfloat16", 64, 16, "wgmma")])
def test_route_is_chosen_from_dtype_and_head_dims(dtype, D, Dv, want):
    assert fa.route(getattr(torch, dtype), D, Dv) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_path_empty_rows_give_zero_like_pallas(jx, dtype):
    """Non-causal window 24 over 32 keys: queries from 55 on see no key.
    The CPU path gives 0 there, as the Pallas kernel does."""
    arrs = _inputs(2, 96, 32, 4, 2, 64)
    got = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
                              causal=False, window=24)
    assert bool((got[:, 55:] == 0).all())
    pallas = jx.pallas(*(jx.jnp.asarray(a).astype(dtype) for a in arrs), causal=False,
                       window=24, blk_q=16, blk_k=16, interpret=True)
    _close(_f32(got), pallas, dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", SHAPES[:2])
@pytest.mark.parametrize("causal,window", MASKS)
def test_cpu_path_grad_matches_jax_blocked_attention(jx, B, Sq, Skv, H, KV, D, causal,
                                                     window):
    import jax
    from repro.models.layers import blocked_attention
    arrs = _inputs(B, Sq, Skv, H, KV, D)
    do = np.random.default_rng(1).normal(size=(B, Sq, H, D)).astype(np.float32)
    want = jax.grad(lambda q, k, v: (blocked_attention(
        q, k, v, causal=causal, window=window, block=16) * do).sum(), argnums=(0, 1, 2))(
            *(jx.jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g.numpy(), w, "float32")


@pytest.mark.parametrize("dtype,D,accumulator", [("bfloat16", 64, True), ("bfloat16", 128, True),
                                                ("bfloat16", 32, False), ("float32", 64, False),
                                                ("bfloat16", 96, True)])
def test_bwd_scratch_holds_delta_then_the_zeroed_dq_accumulator(dtype, D, accumulator):
    """The backward's fp32 scratch: B * H * Sq row sums, and for the wgmma
    route (bf16, D or Dv above 32) the (B, Sq, H, D) dQ accumulator from the
    next multiple of 4 floats (the kernels' dq_acc_offset), zeroed for their
    atomics.  At D 96 the v head dim is MLA's 64."""
    q = torch.ones((2, 5, 3, D), dtype=getattr(torch, dtype))
    scratch = fa._bwd_scratch(q, 64 if D == 96 else D)
    assert scratch.dtype == torch.float32 and scratch.device == q.device
    if accumulator:
        assert scratch.numel() == 32 + 2 * 5 * 3 * D          # 30 row sums, padded to 32
        assert bool((scratch == 0).all())
    else:
        assert scratch.numel() == 2 * 3 * 5


def test_bench_attention_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.launch import bench_attention
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        bench_attention.main([])


def test_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)


# ----------------------------------------------------------- on the card

@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", CARD_MASKS)
def test_kernel_matches_plain_on_card(cuda, B, Sq, Skv, H, KV, D, dtype, causal, window):
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _inputs(B, Sq, Skv, H, KV, D))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = tref.attention_ref(q, k, v, causal=causal, window=window or 0)
    _close(_f32(got), _f32(want), dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,window", HYMBA_CARD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_group_of_five_with_window_matches_plain_on_card(cuda, B, Sq, Skv, H, KV, D,
                                                                window, dtype):
    """Output, then dq, dk and dv (dk and dv summed over the 5 query heads
    of each kv head), against the plain version and its autograd."""
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _inputs(B, Sq, Skv, H, KV, D, seed=3))
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    _close(_f32(got), _f32(tref.attention_ref(q, k, v, causal=True, window=window)), dtype)
    do = torch.from_numpy(_inputs(B, Sq, Sq, H, H, D, seed=4)[0]).to(cuda, q.dtype)
    got, want = _kernel_and_plain_grads(q, k, v, do, causal=True, window=window)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _grad_close(g, w, TOL[dtype])


def test_kernel_reads_strided_views_on_card(cuda):
    """q/k/v sliced out of one fused projection, as strided views."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 64, 8, 32)).astype(np.float32)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attention_cuda(q, k, v, causal=True)
    _close(_f32(got), _f32(tref.attention_ref(q, k, v, causal=True)), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_empty_rows_give_zero_on_card(cuda, dtype):
    """Non-causal window 24 over 32 keys: queries from 55 on see no key.
    Those rows are 0, as in the Pallas kernel and the plain version."""
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _inputs(2, 96, 32, 4, 2, 64))
    got = flash_attention_cuda(q, k, v, causal=False, window=24)
    assert bool((got[:, 55:] == 0).all())
    _close(_f32(got), _f32(tref.attention_ref(q, k, v, causal=False, window=24)), dtype)


def _grad_close(got, want, tol):
    d = (got.float() - want.float()).abs()
    assert bool((d <= tol * (1 + want.float().abs())).all()), float(d.max())


def _kernel_and_plain_grads(q, k, v, do, **kw):
    """(dq, dk, dv) through the kernels and through autograd of the plain
    version, from the same leaves."""
    out = []
    for fn in (fa.flash_attention, tref.attention_ref):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out.append(torch.autograd.grad(fn(*leaves, **kw), leaves, do))
    return out


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", CARD_MASKS)
def test_kernel_grad_matches_plain_on_card(cuda, B, Sq, Skv, H, KV, D, dtype, causal, window):
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _inputs(B, Sq, Skv, H, KV, D))
    do = torch.from_numpy(_inputs(B, Sq, Sq, H, H, D, seed=1)[0]).to(cuda, q.dtype)
    before = (flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches)
    got, want = _kernel_and_plain_grads(q, k, v, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        _grad_close(g, w, TOL[dtype])


@pytest.mark.parametrize("D", [64, 128])
def test_kernel_grad_runs_agree_on_card(cuda, D):
    """The bf16 backward adds dq with atomics, so its sum order changes from
    run to run: two runs on the same inputs agree within the bf16
    tolerance, |d| <= 2e-2·(1+|g|)."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(2, 512, 512, 8, 2, D))
    do = torch.from_numpy(_inputs(2, 512, 512, 8, 8, D, seed=1)[0]).to(cuda, torch.bfloat16)
    o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        _grad_close(a, b, TOL["bfloat16"])


def test_kernel_grad_of_empty_rows_is_zero_on_card(cuda):
    """Non-causal window 24 over 32 keys: queries from 55 on see no key;
    their dq is 0 and they add nothing to dk, dv."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _inputs(2, 96, 32, 4, 2, 64))
    do = torch.ones_like(q)
    (dq, dk, dv), want = _kernel_and_plain_grads(q, k, v, do, causal=False, window=24)
    assert bool((dq[:, 55:] == 0).all())
    for g, w in zip((dq, dk, dv), want):
        _grad_close(g, w, TOL["float32"])


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv", MLA_CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", CARD_MASKS)
def test_kernel_mla_head_dims_match_plain_on_card(cuda, B, Sq, Skv, H, KV, D, Dv, dtype, causal,
                                                  window):
    """v of its own head dim, forward and backward, on the route the
    dtype and head dims name (minicpm3's bf16 96 / 64: wgmma)."""
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _inputs(B, Sq, Skv, H, KV, D, Dv=Dv))
    do = torch.from_numpy(_inputs(B, Sq, Sq, H, H, Dv, seed=1)[0]).to(cuda, q.dtype)
    routes = dict(flash_attention_cuda.routes), dict(fa.flash_attention_bwd_cuda.routes)
    got, want = _kernel_and_plain_grads(q, k, v, do, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(_f32(out), _f32(tref.attention_ref(q, k, v, causal=causal, window=window or 0)), dtype)
    took = fa.route(q.dtype, D, Dv)
    assert flash_attention_cuda.routes[took] == routes[0][took] + 2
    assert fa.flash_attention_bwd_cuda.routes[took] == routes[1][took] + 1
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == q.dtype and g.shape == x.shape
        _grad_close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nd,vd,H", [(64, 64, 40), (16, 16, 4)])
def test_kernel_reads_strided_v_view_on_card(cuda, dtype, nd, vd, H):
    """MLA's v is the view kvb[..., nd:] of its (B, S, H, nd + vd)
    projection: the kernels read it through its strides and give what its
    contiguous copy gives, forward and backward."""
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    kvb = torch.from_numpy(rng.normal(size=(2, 128, H, nd + vd)).astype(np.float32)).to(cuda, dt)
    q = torch.from_numpy(rng.normal(size=(2, 128, H, nd + 32)).astype(np.float32)).to(cuda, dt)
    k = torch.from_numpy(rng.normal(size=(2, 128, H, nd + 32)).astype(np.float32)).to(cuda, dt)
    do = torch.from_numpy(rng.normal(size=(2, 128, H, vd)).astype(np.float32)).to(cuda, dt)
    v = kvb[..., nd:]
    assert not v.is_contiguous()
    view, copy = (_kernel_and_plain_grads(q, k, x, do, causal=True)[0] for x in (v, v.contiguous()))
    fwd = [flash_attention_cuda(q, k, x, causal=True) for x in (v, v.contiguous())]
    torch.cuda.synchronize()
    assert torch.equal(fwd[0], fwd[1])
    for a, b in zip(view, copy):
        _grad_close(a, b, TOL["bfloat16"])   # dq adds with atomics on the wgmma route


def test_serving_path_writes_no_lse_on_card(cuda):
    """Without autograd the wrapper is the forward kernel alone."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _inputs(1, 32, 32, 2, 2, 16))
    with torch.inference_mode():
        o = fa.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None
    _close(_f32(o), _f32(tref.attention_ref(q, k, v, causal=True)), "float32")
