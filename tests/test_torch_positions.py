"""The two position schemes beside rope, against the JAX package's, from
the same parameters (built by JAX ``init_lm``, carried over through
``repro_torch.convert``) and the same numpy tokens, on the CPU: qwen2-vl's
M-RoPE (three position streams, t, h and w, each rotating its section of
the frequency slots) and granite's learned absolute positions (a table
added to the embedding).  SMOKE widths.

Tolerances: cos/sin 1e-4 (positions up to 2048: one float32 ulp of a
frequency moves an angle of 2048 by ~1e-4); logits, caches and gradients
1e-4 at float32 compute (sums in another order), as
``test_torch_lm.py``.  The decode-gap rule of ``chip_smoke.py`` phase 4 is
measured here at full depth."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import tree_leaves

CPU = torch.device("cpu")
QWEN, GRANITE = "qwen2-vl-7b", "granite-20b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    threads of the suite's parallel workers would contend for the cores
    (a 52-layer decode loop ran ~200x slower with six workers of eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute_dtype="float32", **kw):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype, **kw),
            dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype, **kw))


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jlm.init_lm(cfg, jax.random.PRNGKey(seed)))


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(1, 255, size=(B, S)).astype(np.int32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _image_grid(B, text, side, extra):
    """(3, B, text + side² + extra) positions (t, h, w): ``text`` tokens at
    t = h = w = i, a side x side image at t = text, h = text + row, w = text
    + col, then ``extra`` tokens at t = h = w = their index, where
    ``decode_step`` puts a decoded token (all three streams at its pos)."""
    row, col = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    img = np.stack([np.full(side * side, text), text + row.ravel(), text + col.ravel()])
    n = text + side * side
    pos = np.concatenate([np.broadcast_to(np.arange(text), (3, text)), img,
                          np.broadcast_to(np.arange(n, n + extra), (3, extra))], 1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, n + extra)), np.int32)


@pytest.mark.parametrize("dim,sections,theta", [(128, (16, 24, 24), 1e6), (32, (4, 6, 6), 1e6),
                                                (16, (2, 3, 3), 1e4)])
def test_mrope_cos_sin_matches_jax(dim, sections, theta):
    pos = np.random.default_rng(dim).integers(0, 2048, size=(3, 2, 40)).astype(np.int32)
    jc, js = jl.mrope_cos_sin(jnp.asarray(pos), dim, theta, sections)
    tc, ts = tl.mrope_cos_sin(torch.from_numpy(pos), dim, theta, sections)
    assert tc.shape == ts.shape == (2, 40, dim // 2) and tc.dtype == torch.float32
    _close(tc, jc)
    _close(ts, js)
    # slot f follows the stream its section gives it
    start = 0
    for i, sec in enumerate(sections):
        want, _ = tl.rope_cos_sin(torch.from_numpy(pos[i]), dim, theta)
        assert torch.equal(tc[..., start:start + sec], want[..., start:start + sec])
        start += sec
    with pytest.raises(ValueError, match="sum"):
        tl.mrope_cos_sin(torch.from_numpy(pos), dim, theta, (*sections[:2], sections[2] + 1))


def test_qwen2_vl_image_grid_matches_jax():
    """Forward, prefill (caches included) and decode of qwen2-vl SMOKE on 4
    text tokens, a 4 x 4 image grid and 4 more tokens, whose three position
    streams differ; and the port's teacher-forced decode against its own
    forward over the same positions."""
    jc, tc = _cfgs(QWEN)
    params = _np_params(jc)
    tp = params_from_numpy(params, CPU)
    B, P, S = 2, 20, 24
    toks = _tokens(B, S, seed=1)
    pos = _image_grid(B, 4, 4, S - P)
    assert not np.array_equal(pos[1], pos[2]) and not np.array_equal(pos[0], pos[1])
    want, _ = jlm.forward(jc, params, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = tlm.forward(tc, tp, torch.from_numpy(toks), torch.from_numpy(pos))
    _close(got, want)
    text, _ = tlm.forward(tc, tp, torch.from_numpy(toks))
    assert float((text - got).abs().max()) > 1e-2     # the grid reaches the logits
    jlog, jcache = jlm.prefill(jc, params, jnp.asarray(toks[:, :P]), S + 4,
                               jnp.asarray(pos[..., :P]))
    tlog, tcache = tlm.prefill(tc, tp, torch.from_numpy(toks[:, :P]), S + 4,
                               torch.from_numpy(pos[..., :P]))
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    outs = []
    for t in range(P, S):
        nxt = toks[:, t:t + 1]
        jlog, jcache = jlm.decode_step(jc, params, jcache, jnp.asarray(nxt))
        tlog, tcache = tlm.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog)
        outs.append(tlog[:, 0])
    _close(torch.stack(outs, 1), got[:, P:])


def test_qwen2_vl_text_positions_are_rope():
    """Without positions, the forward puts every token at t = h = w = its
    index, and the model equals the rope model of the same weights: M-RoPE
    with three equal streams is rope."""
    _, tc = _cfgs(QWEN)
    params = tlm.init_lm(tc, torch.Generator(CPU).manual_seed(0))
    toks = torch.from_numpy(_tokens(2, 16, seed=2))
    got, _ = tlm.forward(tc, params, toks)
    rope, _ = tlm.forward(dataclasses.replace(tc, pos="rope"), params, toks)
    _close(got, rope, 1e-6)


@pytest.mark.parametrize("tp_repeat_kv,pad_heads_to", [(True, 16), (True, 3), (True, 0),
                                                      (False, 0)])
def test_qwen2_vl_kv_repeat_and_head_padding_change_nothing(tp_repeat_kv, pad_heads_to):
    """The JAX model repeats the kv heads to H and pads the heads to a
    multiple of ``pad_heads_to`` (qwen2-vl-7b: 28 to 32) for the mesh; the
    port runs the 4 SMOKE heads on their 2 kv heads.  Same logits either
    way."""
    jc, tc = _cfgs(QWEN, tp_repeat_kv=tp_repeat_kv, pad_heads_to=pad_heads_to)
    params = _np_params(jc)
    toks = _tokens(2, 24, seed=3)
    pos = _image_grid(2, 4, 4, 4)
    want, _ = jlm.forward(jc, params, jnp.asarray(toks), jnp.asarray(pos))
    got, _ = tlm.forward(tc, params_from_numpy(params, CPU), torch.from_numpy(toks),
                         torch.from_numpy(pos))
    _close(got, want)


def test_granite_pos_table_gradient_matches_jax():
    """The learned table's gradient against ``jax.grad``: rows 0..S-2 carry
    the loss, row S-1 (the last token predicts nothing) and the rows past S
    are exactly 0 on both sides."""
    jc, tc = _cfgs(GRANITE)
    params = _np_params(jc)
    S = 32
    toks = _tokens(2, S, seed=4)
    jgrads = jax.grad(lambda p: jlm.loss_fn(jc, p, {"tokens": jnp.asarray(toks)})[0])(params)
    tp = params_from_numpy(params, CPU)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    loss, _ = tlm.loss_fn(tc, tp, {"tokens": torch.from_numpy(toks)})
    (grad,) = torch.autograd.grad(loss, [tp["pos_table"]])
    want = np.asarray(jgrads["pos_table"])
    assert grad.shape == want.shape == (tc.max_positions, tc.d_model)
    _close(grad, want)
    assert not bool(grad[S - 1:].any()) and not want[S - 1:].any()
    assert bool(grad[:S - 1].abs().sum(-1).gt(0).all())


def test_granite_decode_clamps_at_the_table_end():
    """Decode steps at pos 126..130 of a 128-row table: rows 126, 127 and
    then 127 again, as ``dynamic_slice_in_dim`` clamps the start, against
    the JAX model step by step."""
    jc, tc = _cfgs(GRANITE)
    assert tc.max_positions == 128
    params = _np_params(jc)
    tp = params_from_numpy(params, CPU)
    P = 126
    toks = _tokens(1, P + 5, seed=5)
    jlog, jcache = jlm.prefill(jc, params, jnp.asarray(toks[:, :P]), P + 8)
    tlog, tcache = tlm.prefill(tc, tp, torch.from_numpy(toks[:, :P]), P + 8)
    _close(tlog, jlog)
    for t in range(P, P + 5):
        nxt = toks[:, t:t + 1]
        jlog, jcache = jlm.decode_step(jc, params, jcache, jnp.asarray(nxt))
        tlog, tcache = tlm.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog)
    assert int(tcache["pos"]) == P + 5
    # past the end the step reads the last row: a table whose last row is
    # zeroed changes the step at pos 130
    zeroed = dict(tp, pos_table=tp["pos_table"].clone())
    zeroed["pos_table"][-1] = 0
    cache = dict(tcache, pos=torch.tensor(130, dtype=torch.int32))
    a, _ = tlm.decode_step(tc, tp, {k: v.clone() for k, v in cache.items()}, torch.ones(1, 1))
    b, _ = tlm.decode_step(tc, zeroed, {k: v.clone() for k, v in cache.items()},
                           torch.ones(1, 1))
    assert float((a - b).abs().max()) > 1e-3


def test_positions_the_model_cannot_take_raise():
    base = get_smoke(QWEN)
    with pytest.raises(ValueError, match="sections"):
        tlm.check_ported(dataclasses.replace(base, mrope_sections=(4, 6, 5)))
    with pytest.raises(ValueError, match="table"):
        tlm.check_ported(dataclasses.replace(get_smoke(GRANITE), max_positions=0))
    with pytest.raises(ValueError, match="rope, learned or mrope"):
        tlm.check_ported(dataclasses.replace(base, pos="alibi"))
    with pytest.raises(NotImplementedError, match="MLA"):
        tlm.check_ported(dataclasses.replace(get_smoke("minicpm3-4b"), pos="learned"))
    with pytest.raises(NotImplementedError, match="foo"):
        tlm.check_ported(dataclasses.replace(base, family="foo"))
    # the encoder-decoder is ported, with its learned decoder positions only
    with pytest.raises(NotImplementedError, match="learned decoder positions"):
        tlm.check_ported(dataclasses.replace(base, family="encdec"))
    tlm.check_ported(get_smoke("whisper-small"))
    tlm.check_ported(get_smoke("qwen3-moe-30b-a3b"))   # the MoE family is ported


@pytest.mark.parametrize("arch", ["minitron-8b", GRANITE, QWEN])
def test_bf16_decode_gap_at_full_depth(arch):
    """The port's teacher-forced decode against its forward at the arch's
    full depth (32, 52 and 28 layers; SMOKE widths, 32 tokens): the rule
    ``chip_smoke.py`` phase 4 holds the full-width model to, max |logit
    gap| under 2e-3 in float32 and, in bfloat16, a mean gap at most twice
    the model's own bfloat16 noise (mean |bf16 forward - f32 forward|).  On
    the CPU decode and forward run the same plain attention and round
    alike (the gap is often 0); on the card the forward runs K1."""
    S, gaps = 32, {}
    toks = torch.from_numpy(_tokens(1, S, seed=2))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke(arch), n_layers=get_config(arch).n_layers,
                                  compute_dtype=dtype)
        params = tlm.init_lm(cfg, torch.Generator(CPU).manual_seed(1))
        with torch.inference_mode():
            full, _ = tlm.forward(cfg, params, toks)
            _, cache = tlm.prefill(cfg, params, toks[:, :1], S + 2)
            outs = []
            for t in range(1, S):
                logits, cache = tlm.decode_step(cfg, params, cache, toks[:, t:t + 1])
                outs.append(logits[:, 0])
        gaps[dtype] = (torch.stack(outs, 1) - full[:, 1:]).abs(), full
    noise = (gaps["bfloat16"][1] - gaps["float32"][1]).abs()
    print({dtype: f"max {float(g.max()):.3e} mean {float(g.mean()):.3e}"
           for dtype, (g, _) in gaps.items()},
          f"bf16 noise max {float(noise.max()):.3e} mean {float(noise.mean()):.3e}")
    assert float(gaps["float32"][0].max()) < 2e-3
    assert float(gaps["bfloat16"][0].mean()) <= 2 * float(noise.mean())
