"""K1's CUDA sources, forward and backward, on all three routes, built with
g++ against the CPU emulation of CUDA and of ``csrc/hopper.cuh``
(``tests/cuda_shim``, built by its ``emulate.py``) and called through the
wrappers' own ``launch_fwd``/``launch_bwd`` on CPU tensors: the output and
log-sum-exp against ``attention_ref``, and dq, dk, dv against autograd of
it.  The head dims cover each route's widths and the round-up to them (a
head dim between widths runs on zero-filled columns), MLA's q/k 96 with v
64 at full and at SMOKE size, and v as a strided view of a wider
projection.  What the emulation cannot show is whether the card reads
descriptors and runs mbarriers as emulated, nor speed: the card tests in
``test_torch_flash_attention.py`` do that.

Tolerances as there: |d| <= tol·(1+|ref|), 1e-4 in float32 and 2e-2 in
bfloat16, forward and backward.  Shapes stay at a few hundred rows: the
emulation runs one thread per CUDA thread and the blocks one after
another."""
import numpy as np
import pytest
import torch

from cuda_shim import emulate
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    out = tmp_path_factory.mktemp("shim")   # one per session: workers share nothing
    return (fa.load_fwd(emulate.build(fa.SRC, out)),
            fa.load_bwd(emulate.build(fa.BWD_SRC, out)))


CASES = [  # (B, Sq, Skv, H, KV, D, Dv, dtype, causal, window, v a view)
    # wgmma: minicpm3's widths (two q tiles, a ragged k tile), then rounded up
    (1, 160, 160, 2, 1, 96, 64, "bfloat16", True, None, True),
    (1, 96, 80, 2, 2, 88, 56, "bfloat16", False, 24, False),
    (1, 64, 64, 2, 1, 16, 64, "bfloat16", True, None, False),
    (1, 64, 64, 2, 2, 128, 128, "bfloat16", True, None, False),
    (1, 64, 64, 2, 1, 128, 64, "bfloat16", True, None, False),
    (1, 64, 64, 2, 1, 96, 128, "bfloat16", False, None, False),
    (1, 64, 64, 2, 1, 64, 128, "bfloat16", True, None, True),
    (1, 96, 96, 2, 1, 64, 64, "bfloat16", True, 40, False),
    # hymba-1.5b's group of 5 query heads per kv head (two kv heads, so a
    # wrong head-to-group map shows), with a window that cuts inside a
    # 128-key tile across three k tiles
    (1, 320, 320, 10, 2, 64, 64, "bfloat16", True, 130, False),
    # qwen2-vl-7b's odd group of 7 at head dim 128 (two kv heads): three
    # 128-row q tiles and a ragged last k tile of 16 rows
    (1, 272, 272, 14, 2, 128, 128, "bfloat16", True, None, False),
    # MQA at head dim 128, as granite-20b's 48 heads on one kv head: 12 query
    # heads whose dk and dv sum into one, Skv != Sq.  From 9 query heads a kv
    # head on the backward runs its row-sums pass, then P and dS as two bf16
    # terms each (bw::TWO_TERM_GROUP): here, causal over 16 heads with Sq >
    # Skv, and at D 96 (dK's second column block takes the lo term too) over
    # 10 heads with a window and v a view
    (1, 80, 200, 12, 1, 128, 128, "bfloat16", False, None, False),
    (1, 144, 96, 16, 1, 128, 128, "bfloat16", True, None, False),
    (1, 80, 136, 10, 1, 96, 64, "bfloat16", False, 40, True),
    # whisper-small's cross-attention: G 1 at D 64, no mask, 8 decoder
    # queries in one q tile against a ragged count of encoder frames (200:
    # a last k tile of 72 of 128 rows), forward and backward
    (1, 8, 200, 2, 2, 64, 64, "bfloat16", False, None, False),
    # mma.sync: minicpm3 SMOKE's 24 / 16 (MQA, Skv != Sq), and a window
    (1, 48, 80, 4, 1, 24, 16, "bfloat16", True, None, True),
    (2, 40, 40, 4, 2, 24, 16, "bfloat16", True, 12, False),
    (1, 32, 32, 2, 2, 16, 32, "bfloat16", False, None, False),
    # f32 FMA: minicpm3's widths, SMOKE's, and head dims of no width
    (1, 72, 72, 2, 1, 96, 64, "float32", True, None, True),
    (1, 40, 56, 4, 2, 24, 16, "float32", False, None, False),
    (1, 33, 33, 2, 1, 20, 12, "float32", True, 9, False),
]


def _inputs(B, Sq, Skv, H, KV, D, Dv, dtype, view, seed=0):
    """q, k, v and do from a seed; with ``view`` v is the last Dv columns of
    a (B, Skv, KV, D + Dv) projection, as MLA's ``kvb[..., nd:]``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(  # noqa: E731
        getattr(torch, dtype))
    q, k, do = t(B, Sq, H, D), t(B, Skv, KV, D), t(B, Sq, H, Dv)
    v = t(B, Skv, KV, D + Dv)[..., D:] if view else t(B, Skv, KV, Dv)
    return q, k, v, do


def _close(got, want, tol):
    d = (got.float() - want.float()).abs()
    assert bool((d <= tol * (1 + want.float().abs())).all()), float(d.max())


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,Dv,dtype,causal,window,view", CASES)
def test_emulated_kernels_match_plain(entries, B, Sq, Skv, H, KV, D, Dv, dtype, causal, window,
                                      view):
    fwd, bwd = entries
    q, k, v, do = _inputs(B, Sq, Skv, H, KV, D, Dv, dtype, view)
    assert v.is_contiguous() == (not view)
    kw = dict(causal=causal, window=window, scale=None)
    o, lse = fa.launch_fwd(fwd, q, k, v, return_lse=True, stream=None, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.attention_ref(*leaves, causal=causal, window=window or 0)
    assert o.shape == (B, Sq, H, Dv) and o.dtype == q.dtype
    _close(o, want.detach(), TOL[dtype])
    s = torch.einsum("bqhd,bjhd->bhqj", q.float(), k.float().repeat_interleave(H // KV, 2))
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    seen = (j <= i if causal else j >= 0) & ((j > i - window) if window else True)
    want_lse = (s / D ** 0.5).masked_fill(~seen, -torch.inf).logsumexp(-1)
    _close(lse, want_lse.masked_fill(~seen.any(-1), torch.inf), TOL[dtype])

    grads = fa.launch_bwd(bwd, q, k, v, o, lse, do, stream=None, **kw)
    for g, w, x in zip(grads, torch.autograd.grad(want, leaves, do), (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close(g, w, TOL[dtype])
