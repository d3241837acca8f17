"""MLA (multi-head latent attention, minicpm3-4b) module by module: the
port's ``mla_forward`` and ``mla_decode`` against the JAX package's, at
SMOKE size, from the same ``mla_init`` parameters (drawn by JAX, carried
over through ``repro_torch.convert``) and the same numpy inputs, in
float32.

Tolerance 1e-5: both sides compute in float32 and differ only in the order
of their sums (the JAX forward runs ``blocked_attention`` over heads padded
to ``pad_heads_to``; the port runs its attention over the 40 or 4 heads as
they are).  The decode caches are compared after each step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

TOL = 1e-5
ARCH = "minicpm3-4b"


def _cfgs(**kw):
    return (dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32", **kw),
            dataclasses.replace(get_smoke(ARCH), compute_dtype="float32", **kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _setup(jc, seed=0, S=20, B=2):
    params = jax.tree.map(np.asarray, jattn.mla_init(jc, jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return params, x, pos


@pytest.mark.parametrize("pad_heads_to", [0, 16])
@pytest.mark.parametrize("with_rope", [True, False])
def test_mla_forward_matches_jax(pad_heads_to, with_rope):
    """Output and the latent (ckv, k_rope) it returns for the cache; with
    or without rope, and with JAX padding the 4 heads to 16 or not."""
    jc, tc = _cfgs(pad_heads_to=pad_heads_to)
    params, x, pos = _setup(jc)
    jrope = jlm._rope_for(jc, jnp.asarray(pos)) if with_rope else None
    trope = tlm._rope_for(tc, torch.from_numpy(pos)) if with_rope else None
    want, (jckv, jkr) = jattn.mla_forward(jc, params, jnp.asarray(x), jrope, return_kv=True)
    got, (ckv, kr) = tattn.mla_forward(tc, params_from_numpy(params, "cpu"), torch.from_numpy(x),
                                       trope, return_kv=True)
    assert got.shape == (2, 20, tc.d_model) and ckv.shape == (2, 20, tc.kv_lora_rank)
    assert kr.shape == (2, 20, tc.qk_rope_dim)
    _close(got, want)
    _close(ckv, jckv)
    _close(kr, jkr)


def test_mla_decode_matches_jax():
    """Absorbed decode over the latent cache, three steps from a prefilled
    cache: outputs and both caches after each step."""
    jc, tc = _cfgs()
    params, x, pos = _setup(jc, seed=1, S=12)
    tp = params_from_numpy(params, "cpu")
    P, Smax = 8, 16
    _, (ckv, kr) = jattn.mla_forward(jc, params, jnp.asarray(x[:, :P]),
                                     jlm._rope_for(jc, jnp.asarray(pos[:, :P])), return_kv=True)
    jckv = jnp.zeros((2, Smax, jc.kv_lora_rank)).at[:, :P].set(ckv)
    jkr = jnp.zeros((2, Smax, jc.qk_rope_dim)).at[:, :P].set(kr)
    tckv, tkr = torch.from_numpy(np.array(jckv)), torch.from_numpy(np.array(jkr))
    for t in range(P, P + 3):
        xt = x[:, t:t + 1]
        p_t = np.full((2, 1), t, np.int32)
        want, jckv, jkr = jattn.mla_decode(jc, params, jnp.asarray(xt), jckv, jkr, jnp.int32(t),
                                           jlm._rope_for(jc, jnp.asarray(p_t)))
        got, tckv, tkr = tattn.mla_decode(tc, tp, torch.from_numpy(xt), tckv, tkr,
                                          torch.tensor(t, dtype=torch.int32),
                                          tlm._rope_for(tc, torch.from_numpy(p_t)))
        _close(got, want)
        _close(tckv, jckv)
        _close(tkr, jkr)


def test_mla_rope_width_is_twice_the_rope_dim():
    """JAX builds MLA's rope at width 2 * qk_rope_dim (its rope half reads
    the first qk_rope_dim / 2 frequencies), not at head_dim: at full width
    64, where head_dim 96 would give other frequencies with no shape error."""
    cfg = get_config(ARCH)
    pos = torch.arange(5, dtype=torch.int32)[None]
    cos, sin = tlm._rope_for(cfg, pos)
    jcos, jsin = jlm._rope_for(dataclasses.replace(jax_smoke(ARCH), qk_rope_dim=32, head_dim=96),
                               jnp.asarray(pos.numpy()))
    assert cos.shape == (1, 5, 32) == tuple(jcos.shape)
    _close(cos, jcos)
    _close(sin, jsin)


def test_mla_decode_gap_at_full_depth():
    """The port's absorbed latent decode against its expanded forward at
    minicpm3-4b's 62 layers (SMOKE widths, 32 tokens): the rule
    ``chip_smoke.py`` phase 4 holds the full-width model to, max |logit
    gap| under 2e-3 in float32 and 0.25 in bfloat16.  The bfloat16 mean
    gap sits at the model's own bfloat16 noise (mean |bf16 forward - f32
    forward|), so that noise is no bound for MLA, unlike mamba2."""
    S, gaps = 32, {}
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 255, size=(1, S)).astype(np.int32))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke(ARCH), n_layers=62, compute_dtype=dtype)
        params = tlm.init_lm(cfg, torch.Generator("cpu").manual_seed(1))
        with torch.inference_mode():
            full, _ = tlm.forward(cfg, params, toks)
            _, cache = tlm.prefill(cfg, params, toks[:, :1], S + 2)
            outs = []
            for t in range(1, S):
                logits, cache = tlm.decode_step(cfg, params, cache, toks[:, t:t + 1])
                outs.append(logits[:, 0])
        gaps[dtype] = (torch.stack(outs, 1) - full[:, 1:]).abs(), full
    noise = float((gaps["bfloat16"][1] - gaps["float32"][1]).abs().mean())
    print({dtype: f"max {float(g.max()):.3e} mean {float(g.mean()):.3e}" for dtype, (g, _) in gaps.items()},
          f"bf16 noise mean {noise:.3e}")
    assert float(gaps["float32"][0].max()) < 2e-3
    assert float(gaps["bfloat16"][0].max()) < 0.25
