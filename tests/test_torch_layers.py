"""The port's layer functions against the JAX package's, at float32, on
the same numpy inputs.  Tolerance 1e-5: both sides compute in float32 and
differ only in the order of their sums."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = 1e-5
WINDOWS = [None, 24, 1 << 30]


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_dense_init_scale_and_dtype():
    gen = torch.Generator("cpu").manual_seed(0)
    w = tl.dense_init(gen, (256, 512), 256, torch.float32, "cpu")
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / math.sqrt(256)) < 2e-3
    assert tl.dense_init(gen, (4, 8), 4, torch.bfloat16, "cpu").dtype == torch.bfloat16


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(2, 5, 64)).astype(np.float32), rng.normal(size=64).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x), _pair(w)
    _close(tl.rmsnorm(tx, tw, 1e-5), jl.rmsnorm(jx, jw, 1e-5))


def test_rope_cos_sin_and_apply_rope():
    rng = np.random.default_rng(1)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    jp, tp = _pair(pos)
    jc, js = jl.rope_cos_sin(jp, 16, 500000.0)
    tc, ts = tl.rope_cos_sin(tp, 16, 500000.0)
    _close(tc, jc)
    _close(ts, js)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    jx, tx = _pair(x)
    _close(tl.apply_rope(tx, tc, ts), jl.apply_rope(jx, jc, js))


def test_swiglu():
    rng = np.random.default_rng(2)
    arrs = [rng.normal(size=s).astype(np.float32) / math.sqrt(s[0])
            for s in [(64, 64), (64, 128), (64, 128), (128, 64)]]
    arrs[0] *= math.sqrt(64)
    js, ts = zip(*(_pair(a) for a in arrs))
    _close(tl.swiglu(*ts), jl.swiglu(*js))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention(causal, window):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 48, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 48, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 48, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(k), _pair(v)
    got = tl.blocked_attention(tq, tk, tv, causal=causal, window=window, block=16, scale=0.3)
    want = jl.blocked_attention(jq, jk, jv, causal=causal, window=window, block=16, scale=0.3)
    _close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_blocked_attention_offset_and_padding(window):
    """A continuation chunk: queries start at position 16 of a 48-slot
    cache whose last 8 slots are padding."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(1, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 48, 1, 16)).astype(np.float32)
    v = rng.normal(size=(1, 48, 1, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(k), _pair(v)
    kw = dict(causal=True, window=window, block=16, q_offset=16)
    got = tl.blocked_attention(tq, tk, tv, kv_len=40, **kw)
    want = jl.blocked_attention(jq, jk, jv, kv_len=jnp.int32(40), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("pos", [5, 37, [3, 40]])
def test_decode_attention(window, pos):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 48, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 48, 2, 16)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(kc), _pair(vc)
    p = np.asarray(pos, np.int32)
    got = tl.decode_attention(tq, tk, tv, pos=torch.from_numpy(p), window=window, scale=0.2)
    want = jl.decode_attention(jq, jk, jv, pos=jnp.asarray(p), window=window, scale=0.2)
    _close(got, want)
