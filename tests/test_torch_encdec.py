"""The port's encoder-decoder (whisper-small, ``repro_torch.models.encdec``)
against the JAX package's ``repro.models.encdec``, on the CPU at SMOKE
widths: the same numpy parameters (drawn by the JAX model, carried over by
``repro_torch.convert``), frames and tokens on both sides, function by
function (``sinusoid_pos``, ``layernorm``, ``_mlp``, ``encode``,
``cross_kv``) and for the model as a whole (``forward``, ``prefill`` with
every cache entry, ``decode_step`` over several steps, the loss and every
gradient against ``jax.grad``), with the JAX model's head padding
(``pad_heads_to``, which the port drops) off and on.

Tolerances: 1e-5 in float32, for the layer functions and for the model's
logits, caches, loss and gradients (sums in another order); 1e-4 for the
sinusoid table (at 1500 positions one float32 ulp of a frequency moves an
angle by ~1e-4: measured 3.1e-5); in bfloat16 5e-2 for logits, caches
and states, as the dense models' in ``test_torch_lm.py`` (the two
frameworks round the activations at different places), 5e-3 for the loss
and 1e-2·(1+|ref|) for the gradients, as ``test_torch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models.registry import build as jax_build
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import cache_to_numpy, params_from_numpy
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models.registry import build
from repro_torch.optim.adamw import tree_leaves

ARCH = "whisper-small"
CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PADS = [0, 16]            # the JAX model's pad_heads_to: off, and the full config's
CACHE_KEYS = ("k", "v", "ek", "ev")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    threads of the suite's parallel workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(compute_dtype="float32", pad=0, **kw):
    """(the JAX config with ``pad_heads_to=pad``, the port's), SMOKE."""
    return (dataclasses.replace(jax_smoke(ARCH), compute_dtype=compute_dtype,
                                pad_heads_to=pad, **kw),
            dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype, **kw))


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jax_build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0)))


def _frames(B, S, seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _tokens(B, S, seed=0, vocab=256):
    return np.random.default_rng(seed + 100).integers(1, vocab - 1, size=(B, S)).astype(np.int32)


def _batches(frames, toks):
    return ({"frames": jnp.asarray(frames), "dec_tokens": jnp.asarray(toks)},
            {"frames": torch.from_numpy(frames), "dec_tokens": torch.from_numpy(toks)})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("S,d", [(1500, 768), (40, 64), (1, 16)])
def test_sinusoid_pos_matches_jax(S, d):
    got = te.sinusoid_pos(S, d)
    assert got.shape == (S, d) and got.dtype == torch.float32
    _close(got, je.sinusoid_pos(S, d), 1e-4)
    # sines, then cosines: column 0 is sin(pos), column d/2 cos(pos)
    _close(got[:, 0], torch.sin(torch.arange(S, dtype=torch.float32)), 1e-4)
    _close(got[:, d // 2], torch.cos(torch.arange(S, dtype=torch.float32)), 1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_layernorm_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tl.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = jl.layernorm(jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.asarray(b), 1e-5)
    assert got.dtype == tx.dtype
    _close(_np(got), want, tol)


def _mlp_inputs(np_params):
    """The first encoder layer's MLP with random biases, and inputs whose
    pre-activations spread over |x| up to ~4, where the two GELUs differ."""
    rng = np.random.default_rng(2)
    pl = {k: v[0] for k, v in np_params["enc_layers"]["mlp"].items()}
    pl["b1"] = rng.normal(size=pl["b1"].shape).astype(np.float32)
    pl["b2"] = rng.normal(size=pl["b2"].shape).astype(np.float32)
    return pl, (rng.normal(size=(2, 7, 64)) * 1.5).astype(np.float32)


def test_mlp_matches_jax_and_is_the_tanh_gelu(np_params):
    """``jax.nn.gelu`` is the tanh approximation by default: the port's MLP
    matches it at 1e-5, and the same MLP with the erf GELU (PyTorch's
    default) does not."""
    pl, x = _mlp_inputs(np_params)
    want = np.asarray(je._mlp(jax.tree.map(jnp.asarray, pl), jnp.asarray(x)))
    tp = params_from_numpy(pl, CPU)
    _close(te._mlp(tp, torch.from_numpy(x)), want, 1e-5)
    h = torch.from_numpy(x) @ tp["w1"] + tp["b1"]
    erf = F.gelu(h) @ tp["w2"] + tp["b2"]
    assert float((erf - torch.from_numpy(want.copy())).abs().max()) > 1e-4


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_kv_match_jax(np_params, dtype, pad):
    jc, tc = _cfgs(dtype, pad)
    frames = _frames(2, 40, seed=3)
    want = je.encode(jc, np_params, jnp.asarray(frames))
    got = te.encode(tc, params_from_numpy(np_params, CPU), torch.from_numpy(frames))
    assert got.dtype == tc.cdt and got.shape == (2, 40, 64)
    _close(_np(got), want, TOL[dtype])
    pl = {k: v[1] for k, v in np_params["dec_layers"]["cross"].items()}
    for a, b in zip(te.cross_kv(tc, params_from_numpy(pl, CPU), got),
                    je.cross_kv(jc, pl, jnp.asarray(_np(got)).astype(dtype))):
        assert a.shape == (2, 40, tc.n_kv_heads, tc.head_dim)
        _close(_np(a), b, TOL[dtype])


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(np_params, dtype, pad):
    jc, tc = _cfgs(dtype, pad)
    jb, tb = _batches(_frames(2, 40, seed=4), _tokens(2, 12, seed=4))
    want, jaux = jax_build(jc).forward(np_params, jb)
    got, aux = build(tc).forward(params_from_numpy(np_params, CPU), tb)
    assert got.dtype == torch.float32 and got.shape == (2, 12, tc.vocab)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(np_params, dtype, pad):
    """The prefill's last logits and every cache entry, then four decode
    steps' logits and the caches after them."""
    jc, tc = _cfgs(dtype, pad)
    jm, tm = jax_build(jc), build(tc)
    toks = _tokens(2, 9, seed=5)
    jb, tb = _batches(_frames(2, 24, seed=5), toks[:, :5])
    tp = params_from_numpy(np_params, CPU)
    jlog, jcache = jm.prefill(np_params, jb, 12)
    tlog, tcache = tm.prefill(tp, tb, 12)
    _close(tlog, jlog, TOL[dtype])
    assert set(tcache) == set(jcache) == {"pos", *CACHE_KEYS}
    for key in CACHE_KEYS:
        assert tcache[key].dtype == tc.cdt and tcache[key].shape == jcache[key].shape
        _close(_np(tcache[key]), jcache[key], TOL[dtype])
    assert int(tcache["pos"]) == int(jcache["pos"]) == 5
    for t in range(5, 9):
        jlog, jcache = jm.decode_step(np_params, jcache, jnp.asarray(toks[:, t:t + 1]))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close(tlog, jlog, TOL[dtype])
    back = cache_to_numpy(tcache)
    for key in CACHE_KEYS:
        _close(back[key], jcache[key], TOL[dtype])
    assert int(tcache["pos"]) == 9


@pytest.mark.parametrize("dtype,tol,loss_tol", [("float32", 1e-5, 1e-5),
                                                ("bfloat16", 1e-2, 5e-3)])
def test_loss_and_grads_match_jax(np_params, dtype, tol, loss_tol):
    jc, tc = _cfgs(dtype)
    jb, tb = _batches(_frames(2, 32, seed=6) * 0.02, _tokens(2, 8, seed=6))
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_build(jc).loss(p, jb), has_aux=True))(np_params)
    params = params_from_numpy(np_params, CPU)
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = build(tc).loss(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    assert abs(float(loss) - float(jloss)) <= loss_tol
    assert abs(float(metrics["ce"]) - float(jmetrics["ce"])) <= loss_tol
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))   # sorted keys
    assert len(want) == len(grads) == 36
    for g, w in zip(grads, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def _decode_gaps(n_layers, dtype, S=16, seed=2, frames=40):
    """|teacher-forced decode - forward| logit gaps of the JAX model and of
    the port at ``n_layers`` encoder and decoder layers, from the same
    numpy parameters, frames and tokens: a one-token prefill, then a step
    for each other token.  Returns (jax gap, port gap, jax forward, port
    forward)."""
    kw = dict(enc_layers=n_layers, dec_layers=n_layers, n_layers=2 * n_layers)
    jc, tc = _cfgs(dtype, **kw)
    jm, tm = jax_build(jc), build(tc)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = _tokens(1, S, seed)
    jb, tb = _batches(_frames(1, frames, seed), toks)
    jfull, _ = jax.jit(jm.forward)(params, jb)
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, S + 2))(
        params, {**jb, "dec_tokens": jb["dec_tokens"][:, :1]})
    step = jax.jit(jm.decode_step)
    tp = params_from_numpy(params, CPU)
    tfull, _ = tm.forward(tp, tb)
    _, tcache = tm.prefill(tp, {**tb, "dec_tokens": tb["dec_tokens"][:, :1]}, S + 2)
    jouts, touts = [], []
    for t in range(1, S):
        lg, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        jouts.append(np.asarray(lg[:, 0]))
        lg, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, t:t + 1]))
        touts.append(lg[:, 0].numpy())
    return (np.abs(np.stack(jouts, 1) - np.asarray(jfull)[:, 1:]),
            np.abs(np.stack(touts, 1) - tfull[:, 1:].numpy()), np.asarray(jfull), tfull.numpy())


def test_jax_decode_matches_its_forward_then_the_port_does():
    """Teacher-forced decode reproduces the forward's logits in the JAX
    model, and in the port: under 2e-3 in float32 (as ``chip_smoke.py``
    phase 4 holds it), under 2e-1 in bfloat16 (``tests/test_models_smoke.py``'s
    bound)."""
    for dtype, bound in (("float32", 2e-3), ("bfloat16", 2e-1)):
        jgap, tgap, _, _ = _decode_gaps(2, dtype)
        assert float(jgap.max()) < bound, (dtype, float(jgap.max()))
        assert float(tgap.max()) < bound, (dtype, float(tgap.max()))


def test_bf16_decode_gap_at_full_depth_tracks_jax():
    """whisper-small's 12 + 12 layers at SMOKE widths: in float32 decode
    equals the forward on both sides (max gap under 2e-3); in bfloat16
    neither side's mean gap reaches its own bfloat16 noise (mean |bf16
    forward - f32 forward|), at 2 layers and at 12 (over three draws at
    12: 0-4e-6x the noise in JAX, 0-0.20x in the port): the gap does not
    grow with depth as mamba2's does.  On the CPU decode and forward run
    the same plain attention; on the card the forward runs K1, whose P
    rounds to bf16, so ``chip_smoke.py`` phase 4 holds the full-width
    bfloat16 decode to twice the noise, as it holds the dense models."""
    depth = get_config(ARCH).dec_layers
    assert get_config(ARCH).enc_layers == depth == 12
    for n in (2, depth):
        f32, bf16 = _decode_gaps(n, "float32"), _decode_gaps(n, "bfloat16")
        for side, name in ((0, "jax"), (1, "port")):
            noise = float(np.abs(bf16[2 + side] - f32[2 + side]).mean())
            print(f"{n} layers {name}: f32 gap max {f32[side].max():.3e}, bf16 gap mean "
                  f"{bf16[side].mean():.3e} max {bf16[side].max():.3e}, noise {noise:.3e}")
            assert f32[side].max() < 2e-3
            assert bf16[side].mean() < noise


def test_decode_reads_the_table_row_at_pos_clamped(np_params):
    """The decoder's position row at decode is ``dec_pos[pos]``, read on the
    device, and past the table the last row, as ``dynamic_slice`` clamps: a
    table whose last row is zeroed changes a step at pos 130 (the SMOKE
    table has 128 rows; the self-attention cache 136), and JAX agrees
    there."""
    jc, tc = _cfgs("float32")
    jm, tm = jax_build(jc), build(tc)
    jb, tb = _batches(_frames(1, 16, seed=7), _tokens(1, 3, seed=7))
    tp = params_from_numpy(np_params, CPU)
    _, jcache = jm.prefill(np_params, jb, 136)
    _, tcache = tm.prefill(tp, tb, 136)
    jcache = dict(jcache, pos=jnp.int32(130))
    cache = dict(tcache, pos=torch.tensor(130, dtype=torch.int32))
    tok = np.ones((1, 1), np.int32)
    a, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()}, torch.from_numpy(tok))
    want, _ = jm.decode_step(np_params, jcache, jnp.asarray(tok))
    _close(a, want, TOL["float32"])
    zeroed = dict(tp, dec_pos=tp["dec_pos"].clone())
    zeroed["dec_pos"][-1] = 0
    b, _ = tm.decode_step(zeroed, {k: v.clone() for k, v in cache.items()},
                          torch.from_numpy(tok))
    assert float((a - b).abs().max()) > 1e-3


def test_init_cache_shapes_match_jax():
    """The registry's ``init_cache``: 1500 encoder frames by default, the
    self-attention's ``max_len`` rows, as JAX's."""
    jc, tc = _cfgs("bfloat16")
    for kw in ({}, {"enc_len": 7}):
        want = jax_build(jc).init_cache(2, 10, **kw)
        got = build(tc).init_cache(2, 10, device="cpu", **kw)
        assert set(got) == set(want)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
            assert got[key].dtype == (torch.int32 if key == "pos" else torch.bfloat16)
    assert build(tc).init_cache(1, 4, device="cpu")["ek"].shape[2] == te.ENC_LEN == 1500
