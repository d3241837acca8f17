"""The port's dense LM (llama3.2-1b SMOKE) against the JAX package's, from
the same parameters (built by JAX ``init_lm``, carried over through
``repro_torch.convert``) and the same numpy tokens.

Tolerances: 1e-4 at float32 compute (both sides in float32, sums in
another order); 5e-2 at bfloat16 compute (the two frameworks round the
activations at different places); decode-equals-forward < 2e-1 as in
``tests/test_models_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import lm as jlm
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import (cache_from_numpy, cache_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")


def _cfgs(compute_dtype):
    return (dataclasses.replace(jax_smoke(ARCH), compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jlm.init_lm(jax_smoke(ARCH), jax.random.PRNGKey(0)))


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab - 1, size=(B, S)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_configs_match_and_unported_archs_raise():
    for f in ("CONFIG", "SMOKE"):
        from repro.configs import llama3_2_1b as jc
        from repro_torch.configs import llama3_2_1b as tc
        assert dataclasses.asdict(getattr(jc, f)) == dataclasses.asdict(getattr(tc, f))
    assert get_smoke(ARCH).cdt == torch.bfloat16 and get_smoke(ARCH).pdt == torch.float32
    with pytest.raises(KeyError, match="mamba2-780m"):
        get_config("mamba2-780m")
    with pytest.raises(NotImplementedError, match="mamba2"):
        build(dataclasses.replace(get_smoke(ARCH), family="ssm"))
    with pytest.raises(NotImplementedError, match="training slice"):
        build(get_smoke(ARCH)).loss({}, {})


def test_params_roundtrip_and_layout(np_params):
    p = params_from_numpy(np_params, CPU)
    back = params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    own = build(get_smoke(ARCH)).init(torch.Generator(CPU).manual_seed(0))
    assert (jax.tree.map(lambda a: a.shape, params_to_numpy(own))
            == jax.tree.map(lambda a: a.shape, np_params))


def test_init_fills_the_stack_layer_by_layer():
    """``init_lm`` draws the embedding, then each layer in turn, into the
    stacked tensors: layer i equals the i-th of consecutive per-layer draws."""
    cfg = get_smoke(ARCH)
    params = tlm.init_lm(cfg, torch.Generator(CPU).manual_seed(3))
    gen = torch.Generator(CPU).manual_seed(3)
    embed = tlm.dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, cfg.pdt)
    assert torch.equal(params["embed"], embed)
    for i in range(cfg.n_layers):
        want = params_to_numpy(tlm._layer_init(cfg, gen))
        got = params_to_numpy(tlm._layer(params["layers"], i))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_forward_matches_jax_f32(np_params):
    jc, tc = _cfgs("float32")
    toks = _tokens(2, 24, tc.vocab)
    want, _ = jlm.forward(jc, np_params, jnp.asarray(toks))
    got, aux = tlm.forward(tc, params_from_numpy(np_params, CPU), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, 1e-4)


def test_forward_matches_jax_f32_untied_unembed():
    jc, tc = (dataclasses.replace(c, tie_embeddings=False) for c in _cfgs("float32"))
    params = jax.tree.map(np.asarray, jlm.init_lm(jc, jax.random.PRNGKey(1)))
    assert params["unembed"].shape == (tc.d_model, tc.vocab)
    toks = _tokens(2, 24, tc.vocab, seed=6)
    want, _ = jlm.forward(jc, params, jnp.asarray(toks))
    got, _ = tlm.forward(tc, params_from_numpy(params, CPU), torch.from_numpy(toks))
    _close(got, want, 1e-4)
    own = tlm.init_lm(tc, torch.Generator(CPU).manual_seed(0))
    assert own["unembed"].shape == (tc.d_model, tc.vocab)


def test_forward_matches_jax_bf16(np_params):
    jc, tc = _cfgs("bfloat16")
    toks = _tokens(2, 24, tc.vocab, seed=1)
    want, _ = jlm.forward(jc, np_params, jnp.asarray(toks))
    got, _ = tlm.forward(tc, params_from_numpy(np_params, CPU), torch.from_numpy(toks))
    _close(got, want, 5e-2)


def test_prefill_and_decode_match_jax_f32(np_params):
    jc, tc = _cfgs("float32")
    toks = _tokens(2, 16, tc.vocab, seed=2)
    tp = params_from_numpy(np_params, CPU)
    jlog, jcache = jlm.prefill(jc, np_params, jnp.asarray(toks), 24)
    tlog, tcache = tlm.prefill(tc, tp, torch.from_numpy(toks), 24)
    _close(tlog, jlog, 1e-4)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], 1e-4)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 16
    for step in range(3):
        nxt = _tokens(2, 1, tc.vocab, seed=10 + step)
        jlog, jcache = jlm.decode_step(jc, np_params, jcache, jnp.asarray(nxt))
        tlog, tcache = tlm.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog, 1e-4)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], 1e-4)
    assert int(tcache["pos"]) == 19


def test_bf16_cache_carries_over_exactly(np_params):
    """A JAX bfloat16 decode cache converts bit for bit, and the port
    decodes on from it as the JAX model does."""
    jc, tc = _cfgs("bfloat16")
    toks = _tokens(2, 8, tc.vocab, seed=3)
    _, jcache = jlm.prefill(jc, np_params, jnp.asarray(toks), 12)
    np_cache = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_numpy(np_cache, CPU)
    assert tcache["k"].dtype == torch.bfloat16 and tcache["pos"].dtype == torch.int32
    back = cache_to_numpy(tcache)
    for key in ("k", "v"):
        np.testing.assert_array_equal(back[key], np_cache[key].astype(np.float32))
    nxt = _tokens(2, 1, tc.vocab, seed=4)
    jlog, _ = jlm.decode_step(jc, np_params, jcache, jnp.asarray(nxt))
    tlog, _ = tlm.decode_step(tc, params_from_numpy(np_params, CPU), tcache,
                              torch.from_numpy(nxt))
    _close(tlog, jlog, 5e-2)


def test_decode_matches_forward():
    """Teacher-forced decode reproduces the full-sequence logits (the
    port's own model, bfloat16 compute)."""
    model = build(get_smoke(ARCH))
    params = model.init(torch.Generator(CPU).manual_seed(0))
    S = 16
    toks = torch.from_numpy(_tokens(1, S, model.cfg.vocab, seed=5))
    full, _ = model.forward(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :1]}, S + 2)
    outs = []
    for t in range(1, S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - full[:, 1:S]).abs().max())
    assert err < 2e-1, f"decode/forward divergence {err}"
    assert int(cache["pos"]) == S
