"""The port's models (llama3.2-1b, mamba2-780m, minicpm3-4b, hymba-1.5b,
minitron-8b, granite-20b, qwen2-vl-7b, the MoE qwen3-moe-30b-a3b and
arctic-480b, and the encoder-decoder whisper-small SMOKE) against the JAX
package's, through both registries' ``Model`` entry points, from the same
parameters (built by the JAX model's ``init``, carried over through
``repro_torch.convert``) and the same numpy tokens (and, for
whisper-small, frames).  For the MoE
models each comparison holds the routes to JAX's first
(``test_torch_moe.routes_as_jax``: equal experts wherever the rounding
cannot have flipped them) and the aux loss to JAX's.

Tolerances: 1e-4 at float32 compute (both sides in float32, sums in
another order); at bfloat16 compute the two frameworks round the
activations at different places: 5e-2 for llama3.2-1b and for
minicpm3-4b (MLA; measured 3.9e-2 to 4.3e-2 over three token draws, under
the JAX model's own bfloat16-to-float32 gap of 6.9e-2 to 1.1e-1) and for
the dense minitron-8b, granite-20b (learned positions) and qwen2-vl-7b
(M-RoPE), the MoE qwen3-moe-30b-a3b and arctic-480b and whisper-small
(``test_torch_encdec.py`` holds it function by function), 0.15 for
mamba2-780m, whose bfloat16 logits lie several times farther from their
own float32 logits than llama's do, on both sides (the gated norm, the
conv and the scan each round), 0.2 for hybrid hymba-1.5b (its SSM half
rounds as mamba2's does; ``test_torch_hybrid.py`` gives the measurements);
decode-equals-forward < 2e-1 as in
``tests/test_models_smoke.py`` (for MLA: the absorbed latent decode
against the expanded forward; for MoE at a capacity that drops nothing,
as decode never drops: ``test_torch_moe.py``)."""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import lm as jlm
from repro.models.registry import build as jax_build
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import (cache_from_numpy, cache_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.models import encdec as te
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build
from test_torch_moe import ROUTER_DP, jax_routes, min_gap, routes_as_jax

ARCHS = ("llama3.2-1b", "mamba2-780m", "minicpm3-4b", "hymba-1.5b", "minitron-8b",
         "granite-20b", "qwen2-vl-7b", "qwen3-moe-30b-a3b", "arctic-480b", "whisper-small")
BF16_TOL = {"llama3.2-1b": 5e-2, "mamba2-780m": 0.15, "minicpm3-4b": 5e-2, "hymba-1.5b": 0.2,
            "minitron-8b": 5e-2, "granite-20b": 5e-2, "qwen2-vl-7b": 5e-2,
            "qwen3-moe-30b-a3b": 5e-2, "arctic-480b": 5e-2, "whisper-small": 5e-2}
CACHE_KEYS = {"llama3.2-1b": ("k", "v"), "mamba2-780m": ("ssm_state", "conv_state"),
              "minicpm3-4b": ("ckv", "krope"),
              "hymba-1.5b": ("k", "v", "ssm_state", "conv_state"),
              "minitron-8b": ("k", "v"), "granite-20b": ("k", "v"), "qwen2-vl-7b": ("k", "v"),
              "qwen3-moe-30b-a3b": ("k", "v"), "arctic-480b": ("k", "v"),
              "whisper-small": ("k", "v", "ek", "ev")}
# 20: not a multiple of mamba2's or hymba's SMOKE chunk 16, and past
# hymba's window 16
PROMPT = {"llama3.2-1b": 16, "mamba2-780m": 20, "minicpm3-4b": 16, "hymba-1.5b": 20,
          "minitron-8b": 16, "granite-20b": 16, "qwen2-vl-7b": 16, "qwen3-moe-30b-a3b": 16,
          "arctic-480b": 16, "whisper-small": 16}
CPU = torch.device("cpu")


@contextlib.contextmanager
def _as_jax(jax_call, dtype):
    """Run ``jax_call()`` recording its MoE routes, then hold the port's
    routes inside the block to them (``routes_as_jax``); yields the JAX
    result.  Prints the inputs' smallest gap and the route report."""
    with jax_routes() as routes:
        out = jax_call()
        jax.effects_barrier()
    if not routes:
        yield out
        return
    with routes_as_jax(routes, ROUTER_DP[dtype]) as report:
        yield out
    K = routes[0][0].shape[-1]
    print(f"routes: {len(routes)} JAX calls, min gap {min_gap(routes, K):.3e}, {report}")
    assert report["calls"] >= len(routes)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    threads of the suite's parallel workers would contend for the cores
    (a 52-layer decode loop ran ~200x slower with six workers of eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute_dtype):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def np_params(arch):
    return jax.tree.map(np.asarray, jax_build(jax_smoke(arch)).init(jax.random.PRNGKey(0)))


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab - 1, size=(B, S)).astype(np.int32)


def _batch(cfg, toks, seed=0):
    """The numpy batch of ``toks`` for ``cfg``'s model: {tokens}, or for
    the encoder-decoder {24 frames drawn from ``seed``, dec_tokens}."""
    if cfg.family != "encdec":
        return {"tokens": toks}
    frames = np.random.default_rng(seed + 50).normal(size=(toks.shape[0], 24, cfg.d_model))
    return {"frames": frames.astype(np.float32), "dec_tokens": toks}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_configs_match_and_unported_archs_raise(arch):
    """Each config equals the JAX package's in every field the JAX config
    has, and holds the defaults in the fields only the port's config has
    (the pattern family's, whose defaults keep every other model as it
    is); every arch of the JAX registry resolves to the port's config
    (whisper-small too, now ported), and an unknown arch or family raises."""
    mod = importlib.import_module(f"repro.configs.{arch.replace('.', '_').replace('-', '_')}")
    own = importlib.import_module(f"repro_torch.configs.{mod.__name__.split('.')[-1]}")
    theirs = {f.name for f in dataclasses.fields(mod.ModelConfig)}
    port_only = {f.name: f.default for f in dataclasses.fields(own.ModelConfig)
                 if f.name not in theirs}
    assert set(port_only) == {"router_experts", "routed_scale", "d_shared", "ssm_n_heads",
                              "ssm_groups", "block_pattern"}
    for f in ("CONFIG", "SMOKE"):
        ours = dataclasses.asdict(getattr(own, f))
        assert {k: ours.pop(k) for k in port_only} == port_only
        assert dataclasses.asdict(getattr(mod, f)) == ours
    assert get_config(arch) is own.CONFIG
    assert get_smoke(arch).cdt == torch.bfloat16 and get_smoke(arch).pdt == torch.float32
    whisper = importlib.import_module("repro_torch.configs.whisper_small")
    assert get_config("whisper-small") is whisper.CONFIG
    assert build(get_smoke("whisper-small")).init is not None
    with pytest.raises(KeyError, match="whisper-large"):
        get_config("whisper-large")
    with pytest.raises(NotImplementedError, match="foo"):
        build(dataclasses.replace(get_smoke(arch), family="foo"))
    with pytest.raises(NotImplementedError, match="hybrid"):
        build(dataclasses.replace(get_smoke("mamba2-780m"), attn_kind="gqa"))
    model = build(get_smoke(arch))
    batch = _tb(_batch(model.cfg, _tokens(1, 8, model.cfg.vocab)))
    loss, metrics = model.loss(model.init(torch.Generator(CPU).manual_seed(0)), batch)
    assert loss.shape == () and bool(torch.isfinite(loss)) and set(metrics) == {"ce", "aux"}


def test_params_roundtrip_and_layout(arch, np_params):
    p = params_from_numpy(np_params, CPU)
    back = params_to_numpy(p)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    own = build(get_smoke(arch)).init(torch.Generator(CPU).manual_seed(0))
    assert (jax.tree.map(lambda a: a.shape, params_to_numpy(own))
            == jax.tree.map(lambda a: a.shape, np_params))


def test_init_fills_the_stack_layer_by_layer(arch):
    """``init_lm`` draws the embedding, then each layer in turn, into the
    stacked tensors: layer i equals the i-th of consecutive per-layer draws.
    ``init_encdec`` draws the embedding and the position table, then the
    encoder's layers, then the decoder's, the same way."""
    cfg = get_smoke(arch)
    params = build(cfg).init(torch.Generator(CPU).manual_seed(3))
    gen = torch.Generator(CPU).manual_seed(3)
    embed = tlm.dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, cfg.pdt, CPU)
    assert torch.equal(params["embed"], embed)
    if cfg.family == "encdec":
        torch.randn((cfg.max_positions, cfg.d_model), generator=gen)   # the table
        stacks = (("enc_layers", te._enc_layer_init, cfg.enc_layers),
                  ("dec_layers", te._dec_layer_init, cfg.dec_layers))
    else:
        stacks = (("layers", tlm._layer_init, cfg.n_layers),)
    for key, draw, n in stacks:
        for layer in tlm.unstack(params[key], n):
            want = params_to_numpy(draw(cfg, gen, CPU))
            got = params_to_numpy(layer)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a, b)


def test_forward_matches_jax_f32(arch, np_params):
    jc, tc = _cfgs(arch, "float32")
    batch = _batch(tc, _tokens(2, 24, tc.vocab))
    with _as_jax(lambda: jax_build(jc).forward(np_params, _jb(batch)), "float32") as (want, jaux):
        got, aux = build(tc).forward(params_from_numpy(np_params, CPU), _tb(batch))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (tc.family != "moe")
    assert abs(float(aux) - float(jaux)) <= 1e-5
    _close(got, want, 1e-4)


def test_forward_matches_jax_f32_untied_unembed(arch):
    """With ``tie_embeddings=False`` the decoder-only models draw and use
    an unembedding; the encoder-decoder's logits come from its embedding
    whatever the flag says, in JAX as in the port."""
    jc, tc = (dataclasses.replace(c, tie_embeddings=False) for c in _cfgs(arch, "float32"))
    params = jax.tree.map(np.asarray, jax_build(jc).init(jax.random.PRNGKey(1)))
    untied = tc.family != "encdec"
    assert ("unembed" in params) == untied
    if untied:
        assert params["unembed"].shape == (tc.d_model, tc.vocab)
    batch = _batch(tc, _tokens(2, 24, tc.vocab, seed=6), seed=6)
    want, _ = jax_build(jc).forward(params, _jb(batch))
    got, _ = build(tc).forward(params_from_numpy(params, CPU), _tb(batch))
    _close(got, want, 1e-4)
    own = build(tc).init(torch.Generator(CPU).manual_seed(0))
    assert ("unembed" in own) == untied
    if untied:
        assert own["unembed"].shape == (tc.d_model, tc.vocab)


def test_forward_matches_jax_bf16(arch, np_params):
    jc, tc = _cfgs(arch, "bfloat16")
    batch = _batch(tc, _tokens(2, 24, tc.vocab, seed=1), seed=1)
    with _as_jax(lambda: jax_build(jc).forward(np_params, _jb(batch)), "bfloat16") as (want, jaux):
        got, aux = build(tc).forward(params_from_numpy(np_params, CPU), _tb(batch))
    _close(got, want, BF16_TOL[arch])
    assert abs(float(aux) - float(jaux)) <= 1e-2   # probabilities within ROUTER_DP


def test_prefill_and_decode_match_jax_f32(arch, np_params):
    jc, tc = _cfgs(arch, "float32")
    S = PROMPT[arch]
    batch = _batch(tc, _tokens(2, S, tc.vocab, seed=2), seed=2)
    tp = params_from_numpy(np_params, CPU)
    jm, tm = jax_build(jc), build(tc)
    jlog, jcache = jm.prefill(np_params, _jb(batch), S + 8)
    tlog, tcache = tm.prefill(tp, _tb(batch), S + 8)
    _close(tlog, jlog, 1e-4)
    assert set(tcache) == set(jcache) == {"pos", *CACHE_KEYS[arch]}
    for key in CACHE_KEYS[arch]:
        _close(tcache[key], jcache[key], 1e-4)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for step in range(3):
        nxt = _tokens(2, 1, tc.vocab, seed=10 + step)
        jlog, jcache = jm.decode_step(np_params, jcache, jnp.asarray(nxt))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog, 1e-4)
    for key in CACHE_KEYS[arch]:
        _close(tcache[key], jcache[key], 1e-4)
    assert int(tcache["pos"]) == S + 3


def test_bf16_cache_carries_over_exactly(arch, np_params):
    """A JAX bfloat16 decode cache converts bit for bit, and the port
    decodes on from it as the JAX model does."""
    jc, tc = _cfgs(arch, "bfloat16")
    batch = _batch(tc, _tokens(2, 8, tc.vocab, seed=3), seed=3)
    _, jcache = jax_build(jc).prefill(np_params, _jb(batch), 12)
    np_cache = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_numpy(np_cache, CPU)
    assert tcache["pos"].dtype == torch.int32
    for key in CACHE_KEYS[arch]:
        assert tcache[key].dtype == (torch.float32 if key == "ssm_state" else torch.bfloat16)
    back = cache_to_numpy(tcache)
    for key in CACHE_KEYS[arch]:
        np.testing.assert_array_equal(back[key], np_cache[key].astype(np.float32))
    nxt = _tokens(2, 1, tc.vocab, seed=4)
    with _as_jax(lambda: jax_build(jc).decode_step(np_params, jcache, jnp.asarray(nxt)),
                 "bfloat16") as (jlog, _):
        tlog, _ = build(tc).decode_step(params_from_numpy(np_params, CPU), tcache,
                                        torch.from_numpy(nxt))
    _close(tlog, jlog, BF16_TOL[arch])


def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the full-sequence logits (the
    port's own model, bfloat16 compute; MoE at capacity E / k, where the
    forward drops no pair, as decode never does)."""
    cfg = get_smoke(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build(cfg)
    params = model.init(torch.Generator(CPU).manual_seed(0))
    S = 16
    toks = _tokens(1, S, model.cfg.vocab, seed=5)
    full, _ = model.forward(params, _tb(_batch(cfg, toks, seed=5)))
    _, cache = model.prefill(params, _tb(_batch(cfg, toks[:, :1], seed=5)), S + 2)
    toks = torch.from_numpy(toks)
    outs = []
    for t in range(1, S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - full[:, 1:S]).abs().max())
    assert err < 2e-1, f"decode/forward divergence {err}"
    assert int(cache["pos"]) == S


def _decode_gaps(arch, n_layers, dtype, S=16, **overrides):
    """|teacher-forced decode - forward| logit gaps of the JAX model and of
    the port, from the same numpy parameters and tokens, with both sides'
    forward logits: (jax gap, port gap, jax forward, port forward)."""
    jc, tc = (dataclasses.replace(c, n_layers=n_layers, **overrides) for c in _cfgs(arch, dtype))
    params = jax.tree.map(np.asarray, jlm.init_lm(jc, jax.random.PRNGKey(0)))
    toks = _tokens(1, S, tc.vocab, seed=9)
    jfull, _ = jax.jit(lambda p, t: jlm.forward(jc, p, t))(params, jnp.asarray(toks))
    _, jcache = jax.jit(lambda p, t: jlm.prefill(jc, p, t, S + 2))(params, jnp.asarray(toks[:, :1]))
    step = jax.jit(lambda p, c, t: jlm.decode_step(jc, p, c, t))
    model, tp, tt = build(tc), params_from_numpy(params, CPU), torch.from_numpy(toks)
    tfull, _ = model.forward(tp, {"tokens": tt})
    _, tcache = model.prefill(tp, {"tokens": tt[:, :1]}, S + 2)
    jouts, touts = [], []
    for t in range(1, S):
        lg, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        jouts.append(np.asarray(lg[:, 0]))
        lg, tcache = model.decode_step(tp, tcache, tt[:, t:t + 1])
        touts.append(lg[:, 0].numpy())
    return (np.abs(np.stack(jouts, 1) - np.asarray(jfull)[:, 1:]),
            np.abs(np.stack(touts, 1) - tfull[:, 1:].numpy()), np.asarray(jfull), tfull.numpy())


def _decode_gap(arch, n_layers, dtype, S=16):
    """Mean |teacher-forced decode - forward| logit gap of the JAX model and
    of the port, from the same numpy parameters and tokens."""
    jgap, tgap, _, _ = _decode_gaps(arch, n_layers, dtype, S)
    return float(jgap.mean()), float(tgap.mean())


def _gap_tracks_jax_with_depth(arch):
    """The bfloat16 mean decode gaps at 2 and 16 layers: the port's within
    1.25x of JAX's at each depth, and at 16 layers over 3x those at 2, on
    both sides."""
    gaps = {n: _decode_gap(arch, n, "bfloat16") for n in (2, 16)}
    print({f"{n} layers bf16 mean gap": f"jax {j:.3e} port {t:.3e}" for n, (j, t) in gaps.items()})
    for jax_gap, port_gap in gaps.values():
        assert port_gap <= 1.25 * jax_gap
    for side in (0, 1):
        assert gaps[16][side] > 3 * gaps[2][side]


def test_mamba2_decode_gap_tracks_jax_with_depth():
    """Random-weight mamba2 amplifies bfloat16 rounding with depth, in the
    JAX model as in the port: teacher-forced decode drifts from the forward
    in proportion to the layers.  The port's gap grows with JAX's own and
    stays within 1.25x of it at each depth."""
    _gap_tracks_jax_with_depth("mamba2-780m")


def test_hymba_decode_gap_tracks_jax_with_depth():
    """hymba-1.5b's SSM half makes its bfloat16 decode gap grow with depth
    as mamba2's does, in JAX as in the port, so no fixed bound on it holds
    at 32 layers: ``chip_smoke.py`` holds hymba's bfloat16 decode to its
    forward's own bfloat16 noise, as mamba2's."""
    _gap_tracks_jax_with_depth("hymba-1.5b")


def test_qwen3_moe_decode_gap_at_full_depth_tracks_jax():
    """qwen3-moe-30b-a3b at its 48 layers (SMOKE widths; capacity E / k, so
    that the forward drops no pair, as decode never does): in float32 decode
    equals the forward on both sides (gap under 2e-3); in bfloat16 neither
    side's mean gap reaches its own bfloat16 noise (mean |bf16 forward - f32
    forward|).  On the CPU both sides' gap is mostly 0, and a routing flip at
    a near tie makes the rest: over three token draws 0.003-0.24x the noise
    in JAX and 0-0.23x in the port.  MoE routing adds no drift with depth,
    so ``chip_smoke.py`` phase 4 holds the full-width bfloat16 decode, whose
    forward runs K1, to twice the noise, as it holds the dense models."""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    kw = dict(n_layers=get_config("qwen3-moe-30b-a3b").n_layers,
              capacity_factor=cfg.n_experts / cfg.top_k)
    f32 = _decode_gaps("qwen3-moe-30b-a3b", dtype="float32", **kw)
    bf16 = _decode_gaps("qwen3-moe-30b-a3b", dtype="bfloat16", **kw)
    for side, name in ((0, "jax"), (1, "port")):
        noise = float(np.abs(bf16[2 + side] - f32[2 + side]).mean())
        print(f"{name}: f32 gap max {f32[side].max():.3e}, bf16 gap mean "
              f"{bf16[side].mean():.3e} max {bf16[side].max():.3e}, noise {noise:.3e}")
        assert f32[side].max() < 2e-3
        assert bf16[side].mean() < noise
