"""The port's Mamba-2 block (``models/ssm.py``) against the JAX package's,
from the same parameters (drawn by JAX ``ssm_init``, carried over as numpy)
and the same numpy inputs, at mamba2-780m SMOKE size in float32.

Tolerance 1e-4: both sides compute in float32 and differ only in the order
of their sums (the chunked scan's above all)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_bwd_route, ssd_route
from repro_torch.models import ssm as tssm

ARCH = "mamba2-780m"
TOL = 1e-4


def _cfgs():
    return (dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32"),
            dataclasses.replace(get_smoke(ARCH), compute_dtype="float32"))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jssm.ssm_init(jax_smoke(ARCH), jax.random.PRNGKey(0)))


def _x(B, S, d, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_init_layout_matches_jax(np_params):
    _, tc = _cfgs()
    own = tssm.ssm_init(tc, torch.Generator("cpu").manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in np_params.items()}
    assert all(v.dtype == torch.float32 for v in own.values())
    _close(own["A_log"], np_params["A_log"], 1e-6)
    for k in ("conv_b", "D", "dt_bias", "gnorm"):
        np.testing.assert_array_equal(own[k].numpy(), np_params[k])


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    xBC = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jssm.causal_conv(jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv(torch.from_numpy(xBC), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("S", [32, 20, 2])   # a chunk multiple; ragged; below K-1
def test_ssm_forward_with_state_matches_jax(np_params, S):
    jc, tc = _cfgs()
    x = _x(2, S, tc.d_model, seed=S)
    want, (wst, wconv) = jssm.ssm_forward(jc, np_params, jnp.asarray(x), return_state=True)
    got, (st, conv) = tssm.ssm_forward(tc, params_from_numpy(np_params, "cpu"),
                                       torch.from_numpy(x), return_state=True)
    assert st.dtype == torch.float32 and conv.shape == (2, tc.ssm_conv - 1, wconv.shape[-1])
    _close(got, want)
    _close(st, wst)
    _close(conv, wconv)
    plain = tssm.ssm_forward(tc, params_from_numpy(np_params, "cpu"), torch.from_numpy(x))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("S", [1, 100, 200, 300, 2048])
def test_bf16_prefill_reaches_the_wgmma_route(monkeypatch, S):
    """At mamba2-780m's scan widths (p 64, n 128, ssm_chunk 256; d_model cut
    to 64, so 2 heads), ssm_forward pads a ragged or short prompt to a chunk
    that is a multiple of 64: every bf16 prefill the kernel sees takes its
    wgmma route, reading the projection's views in place when nothing is
    padded."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=64, compute_dtype="bfloat16")
    params = tssm.ssm_init(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    seen = []

    def spy(x, dt, A, B, C, *, chunk):
        seen.append((ssd_route(x, B, C, chunk), x.shape[1] % chunk, x.is_contiguous()))
        return ref.ssd_ref(x, dt, A, B, C, chunk=chunk)

    monkeypatch.setattr(ops, "ssd", spy)
    out = tssm.ssm_forward(cfg, params, torch.from_numpy(_x(1, S, cfg.d_model)).bfloat16())
    assert out.shape == (1, S, cfg.d_model) and bool(out.float().isfinite().all())
    assert seen == [("wgmma", 0, S % 256 != 0)]


@pytest.mark.parametrize("S", [300, 2048])
def test_bf16_backward_reaches_the_wgmma_route(monkeypatch, S):
    """The gradient that reaches the scan's y in a bf16 train step (through
    the slice back to S rows and heads, the D skip, the gated norm) is
    shaped, typed and laid out as the backward's wgmma route reads it, so
    ``ssd_scan``'s autograd ``Function`` hands it over without a copy."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=64, compute_dtype="bfloat16")
    params = tssm.ssm_init(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    for v in params.values():
        v.requires_grad_()
    seen = []

    def spy(x, dt, A, B, C, *, chunk):
        y, state = ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
        y.register_hook(lambda dy: seen.append(ssd_bwd_route(x, B, C, dy, chunk)))
        return y, state

    monkeypatch.setattr(ops, "ssd", spy)
    out = tssm.ssm_forward(cfg, params, torch.from_numpy(_x(1, S, cfg.d_model)).bfloat16())
    out.float().square().mean().backward()
    assert seen == ["wgmma"]


def test_ssm_decode_matches_jax(np_params):
    jc, tc = _cfgs()
    rng = np.random.default_rng(7)
    di, g, n, h, conv_dim = tssm._dims(tc)
    x = _x(2, 1, tc.d_model, seed=8)
    state = rng.normal(size=(2, h, tc.ssm_head_dim, n)).astype(np.float32)
    conv = rng.normal(size=(2, tc.ssm_conv - 1, conv_dim)).astype(np.float32)
    want = jssm.ssm_decode(jc, np_params, jnp.asarray(x), jnp.asarray(state), jnp.asarray(conv))
    got = tssm.ssm_decode(tc, params_from_numpy(np_params, "cpu"), torch.from_numpy(x),
                          torch.from_numpy(state), torch.from_numpy(conv))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_cache_matches_jax(dtype):
    cfg = get_smoke(ARCH)
    st, cv = tssm.ssm_init_cache(cfg, 3, getattr(torch, dtype), "cpu")
    wst, wcv = jssm.ssm_init_cache(jax_smoke(ARCH), 3, jnp.dtype(dtype))
    assert st.shape == wst.shape and st.dtype == torch.float32
    assert cv.shape == wcv.shape and cv.dtype == getattr(torch, dtype)
    assert not st.any() and not cv.any()
