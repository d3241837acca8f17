"""K1, flash attention: the port's CPU path of ``ops.flash_attention``
against the Pallas kernel (interpret mode) and the JAX oracle over the
sweep of ``tests/test_kernels.py``, its gradient against ``jax.grad`` of
the JAX model's ``blocked_attention`` (what the JAX training path
differentiates), and, on a CUDA card, the hand-written forward and
backward kernels against their plain versions (the backward: autograd
through ``attention_ref``).

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


def _inputs(B, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32))


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
                                                ("bfloat16", 32, False), ("float32", 64, False)])
def test_bwd_scratch_holds_delta_then_the_zeroed_dq_accumulator(dtype, D, accumulator):
    """The backward's fp32 scratch: B * H * Sq row sums, and for the bf16
    wgmma kernels (D 64, 128) the (B, Sq, H, D) dQ accumulator from the next
    multiple of 4 floats (the kernels' dq_acc_offset), zeroed for their
    atomics."""
    q = torch.ones((2, 5, 3, D), dtype=getattr(torch, dtype))
    scratch = fa._bwd_scratch(q)
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


def test_serving_path_writes_no_lse_on_card(cuda):
    """Without autograd the wrapper is the forward kernel alone."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _inputs(1, 32, 32, 2, 2, 16))
    with torch.inference_mode():
        o = fa.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None
    _close(_f32(o), _f32(tref.attention_ref(q, k, v, causal=True)), "float32")
