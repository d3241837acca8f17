"""The port's training path (llama3.2-1b SMOKE) against the JAX package's:
the loss and every parameter gradient (also for mamba2-780m, MLA's
minicpm3-4b, hybrid hymba-1.5b, minitron-8b, granite-20b with its learned
position table, qwen2-vl-7b, the MoE qwen3-moe-30b-a3b and arctic-480b
with their aux loss, routes held to JAX's as ``test_torch_moe.py`` does,
and the encoder-decoder whisper-small on frames and decoder tokens),
remat, AdamW with clipping, the
schedule and int8 gradient compression step by step on identical
gradients, the data pipeline, the NVCache-backed loop with crash-safe
resume, and the launcher, all on the CPU.

Parameters are built by JAX ``init_lm`` and carried over through
``repro_torch.convert``; tokens and gradients are numpy arrays handed to
both sides.  Tolerances: loss and gradients 1e-4 at float32 compute (both
in float32, sums in another order; measured ~2e-7, 3.1e-6 for mamba2); at
bfloat16 compute 1e-2·(1+|ref|) for the gradients and 5e-3 for the loss,
because the two frameworks round activations and their cotangents to
bfloat16 at different places (measured 3.0e-3 and 9.1e-4 for llama, 3.1e-3
and 7.2e-4 for minicpm3-4b); mamba2's and hymba's bfloat16 gradients
3e-2·(1+|ref|) (measured 1.44e-2 and 1.12e-2: their gated norm, conv and
scan each round, as their forwards' wider tolerances in
``test_torch_lm.py`` say).  AdamW 1e-6: the same
float32 arithmetic in the same order; compressed gradients exactly equal
(the int8 codes and scales are bit-identical, ``tests/test_torch_quantize.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.core import NVCache as JNVCache
from repro.core import Policy as JPolicy
from repro.data.pipeline import FileBackedTokens as JFileBackedTokens
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import lm as jlm
from repro.models.registry import build as jax_build
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro.storage.fsapi import NVCacheFS as JNVCacheFS
from repro.storage.tiers import DRAM as JDRAM
from repro.storage.tiers import Tier as JTier
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import NVCache, Policy, recover
from repro_torch.data.pipeline import FileBackedTokens, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build
from repro_torch.optim import grad_compress
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW, global_norm, tree_leaves
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import DRAM, Tier
from repro_torch.train import loop as train_loop
from repro_torch.train import steps as tsteps
from test_torch_moe import ROUTER_DP, jax_routes, min_gap, routes_as_jax

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
POL = dict(entry_size=16384, log_entries=8192, page_size=4096,
           read_cache_pages=64, batch_min=8, batch_max=512, verify_crc=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    threads of the suite's parallel workers would contend for the cores
    (a 52-layer decode loop ran ~200x slower with six workers of eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jlm.init_lm(jax_smoke(ARCH), jax.random.PRNGKey(0)))


def _tokens(B=2, S=32, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(1, vocab - 1, size=(B, S)).astype(np.int32)


def _batch(cfg, toks):
    """The numpy batch of ``toks`` for ``cfg``'s model: {tokens}, or for
    the encoder-decoder {frames, dec_tokens}: ``SyntheticTokens``' encdec
    draw (frames of 32 rows at 0.02·N(0, 1), seq // 8 = 4 decoder tokens)."""
    if cfg.family != "encdec":
        return {"tokens": toks}
    return SyntheticTokens(cfg.vocab, toks.shape[0], toks.shape[1], seed=0, family="encdec",
                           d_model=cfg.d_model).next()


def _torch_loss_and_grads(cfg, params, toks):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, toks).items()}
    loss, metrics = build(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, grads


def _jax_grads(np_params, toks, compute_dtype="float32", arch=ARCH):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype)
    batch = {k: jnp.asarray(v) for k, v in _batch(jc, toks).items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_build(jc).loss(p, batch), has_aux=True)(np_params)
    return loss, metrics, jax.tree.map(np.asarray, grads)


# parameter leaves of each SMOKE model (MLA's attention has seven; hymba
# adds the SSM's eight, the two fuse weights and an untied unembedding;
# minitron and qwen2-vl an untied unembedding; granite that and its table;
# qwen3-moe an untied unembedding and the router and three expert tensors in
# place of the MLP; arctic the MLP's three beside them; whisper-small the
# embedding, its position table, two final LayerNorms' 4, an encoder layer's
# 12 and a decoder layer's 18)
LEAVES = {"llama3.2-1b": 11, "mamba2-780m": 11, "minicpm3-4b": 14, "hymba-1.5b": 22,
          "minitron-8b": 12, "granite-20b": 13, "qwen2-vl-7b": 12, "qwen3-moe-30b-a3b": 13,
          "arctic-480b": 16, "whisper-small": 36}


@pytest.mark.parametrize("arch", list(LEAVES))
@pytest.mark.parametrize("compute_dtype,tol,loss_tol", [("float32", 1e-4, 1e-4),
                                                         ("bfloat16", 1e-2, 5e-3)])
def test_loss_and_grads_match_jax(np_params, arch, compute_dtype, tol, loss_tol):
    if arch != ARCH:
        np_params = jax.tree.map(np.asarray, jax_build(jax_smoke(arch)).init(
            jax.random.PRNGKey(0)))
    if arch in ("mamba2-780m", "hymba-1.5b") and compute_dtype == "bfloat16":
        tol = 3e-2
    toks = _tokens()
    jloss, jmetrics, jgrads = _jax_grads(np_params, toks, compute_dtype, arch)
    tc = dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype)
    with jax_routes() as routes:   # the MoE routes of JAX's forward, held below
        jc = dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype)
        jax_build(jc).forward(np_params, {k: jnp.asarray(v) for k, v in _batch(jc, toks).items()})
        jax.effects_barrier()
    with routes_as_jax(routes, ROUTER_DP[compute_dtype]) as report:
        loss, metrics, grads = _torch_loss_and_grads(tc, params_from_numpy(np_params, CPU), toks)
    if routes:
        print(f"routes: min gap {min_gap(routes, tc.top_k):.3e}, {report}")
    assert abs(float(loss) - float(jloss)) <= loss_tol
    assert abs(float(metrics["ce"].detach()) - float(jmetrics["ce"])) <= loss_tol
    assert abs(float(metrics["aux"].detach()) - float(jmetrics["aux"])) <= loss_tol
    assert (float(metrics["aux"].detach()) == 0.0) == (tc.family != "moe")
    want = jax.tree.leaves(jgrads)     # sorted-key order, as tree_leaves gives
    assert len(want) == len(grads) == LEAVES[arch]
    for g, w in zip(grads, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_remat_modes_give_the_same_grads(np_params):
    """"none" saves everything, "dots" the weight products' outputs, "full"
    nothing: the recomputed forward is the same arithmetic, so the
    gradients agree to the last bit on the CPU."""
    toks = _tokens(seed=1)
    out = {}
    for remat in ("none", "dots", "full"):
        tc = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32", remat=remat)
        out[remat] = _torch_loss_and_grads(tc, params_from_numpy(np_params, CPU), toks)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][2], out["none"][2]):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="remat"):
        _torch_loss_and_grads(dataclasses.replace(get_smoke(ARCH), remat="some"),
                              params_from_numpy(np_params, CPU), toks)


def test_schedules_match_jax():
    f, jf = schedules.warmup_cosine(10, 50), jsched.warmup_cosine(10, 50)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        got = float(f(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - float(jf(jnp.int32(step)))) <= 1e-7, step
    assert schedules.constant()(torch.tensor(3)) == jsched.constant()(jnp.int32(3)) == 1.0


def _grads_like(np_params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                        np_params)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_steps_match_jax(np_params, compress, moment_dtype):
    """Three AdamW steps (warmup-cosine schedule, clipping active) on the
    same gradients, with and without int8 compression: parameters, moments
    and the step counter agree within 1e-6 after each.  With bfloat16
    moments a one-ulp float32 difference (XLA may fuse a multiply-add) can
    round a moment to the neighbouring bfloat16 value (seen: 1 element of
    16384), so moments are held to one bfloat16 ulp (rtol 2^-7) and the
    parameters of later steps, which read them, to lr·2^-7."""
    kw = dict(lr=1e-2, clip_norm=1.0, moment_dtype=moment_dtype)
    jopt = jadamw.AdamW(schedule=jsched.warmup_cosine(2, 10), **kw)
    topt = AdamW(schedule=schedules.warmup_cosine(2, 10), **kw)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = jopt.init(jp)
    tp = params_from_numpy(np_params, CPU)
    tstate = topt.init(tp)
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    for i in range(3):
        g = _grads_like(np_params, seed=10 + i)
        jg = jax.tree.map(jnp.asarray, g)
        tg = params_from_numpy(g, CPU)
        if compress:
            jg = jgc.compress_tree(jg)
            tg = grad_compress.compress_tree(tg)
            for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert abs(float(global_norm(tg)) - float(jadamw.global_norm(jg))) <= 1e-5
        updates, jstate, jm = jopt.update(jg, jstate, jp)
        jp = jadamw.apply_updates(jp, updates)
        tm = topt.update(tg, tstate, tp)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        bf16 = moment_dtype == "bfloat16"
        p_atol = kw["lr"] * 2 ** -7 if bf16 and i else 1e-6
        m_rtol = 2 ** -7 if bf16 else 1e-6
        for got, want, rtol, atol in ((tp, jp, 1e-6, p_atol),
                                      (tstate["m"], jstate["m"], m_rtol, 1e-6),
                                      (tstate["v"], jstate["v"], m_rtol, 1e-6)):
            for a, b in zip(tree_leaves(params_to_numpy(got)),
                            jax.tree.leaves(jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol, atol=atol)


def test_train_state_carries_over(np_params):
    """A JAX train state (bfloat16 moments, int32 step) through
    ``repro_torch.convert``: dtypes kept on the way in, values exact both
    ways."""
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jp, "opt": jadamw.AdamW(moment_dtype="bfloat16").init(jp)}
    jstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.1, jstate["opt"]["m"])
    jstate["opt"]["step"] = jnp.int32(7)
    host = jax.tree.map(np.asarray, jstate)
    tstate = params_from_numpy(host, CPU)
    assert tstate["opt"]["step"].dtype == torch.int32 and tstate["opt"]["step"].shape == ()
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tstate["opt"]["m"]))
    assert all(t.dtype == torch.float32 for t in tree_leaves(tstate["params"]))
    for a, b in zip(tree_leaves(params_to_numpy(tstate)), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


def test_synthetic_tokens_bit_identical():
    for kw in (dict(seed=9), dict(seed=3, family="encdec", d_model=8)):
        a, b = SyntheticTokens(256, 2, 32, **kw), JSyntheticTokens(256, 2, 32, **kw)
        for _ in range(4):
            x, y = a.next(), b.next()
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        assert a.state() == b.state()


def test_file_backed_tokens_bit_identical():
    shards = [np.arange(i * 1000, i * 1000 + 300, dtype=np.int32) for i in range(3)]
    nv, jnv = NVCache(Policy(**POL), Tier(DRAM)), JNVCache(JPolicy(**POL), JTier(JDRAM))
    fs, jfs = NVCacheFS(nv), JNVCacheFS(jnv)
    for i, s in enumerate(shards):
        FileBackedTokens.write_shard(fs, f"/s{i}", s)
        JFileBackedTokens.write_shard(jfs, f"/s{i}", s)
    a = FileBackedTokens(fs, [f"/s{i}" for i in range(3)], 2, 50)
    b = JFileBackedTokens(jfs, [f"/s{i}" for i in range(3)], 2, 50)
    for _ in range(10):
        assert np.array_equal(a.next()["tokens"], b.next()["tokens"])
    nv.shutdown()
    jnv.shutdown()


def _setup(tier=None, **nv_kw):
    tier = tier or Tier(DRAM)
    nv = NVCache(Policy(**POL), tier, **nv_kw)
    cfg = get_smoke(ARCH)
    return tier, nv, build(cfg), AdamW(lr=1e-3), SyntheticTokens(cfg.vocab, batch=2, seq=32,
                                                                   seed=9)


def test_train_loss_decreases():
    _tier, nv, model, opt, pipe = _setup()
    _state, hist = train_loop.train(model, opt, pipe, NVCacheFS(nv), total_steps=30,
                                    ckpt_every=10, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, f"loss did not decrease: {first} -> {last}"
    nv.shutdown()


def test_crash_restart_resumes_exactly():
    """Run 17 steps (ckpt@10), 'crash', recover the NVMM log, restart: the
    loop resumes from the step-17 checkpoint with the data pipeline in
    lockstep, runs the 3 steps left, and its state equals an uninterrupted
    20-step run's."""
    tier, nv, model, opt, pipe = _setup(track_crashes=True)
    _, hist1 = train_loop.train(model, opt, pipe, NVCacheFS(nv), total_steps=17,
                                ckpt_every=10, device="cpu")
    assert len(hist1) == 17
    nvmm = nv.crash()           # the step-17 checkpoint may live only in the NVMM log
    recover(nvmm, nv.policy, tier.open)

    nv2 = NVCache(Policy(**POL), tier)
    pipe2 = SyntheticTokens(model.cfg.vocab, batch=2, seq=32, seed=9)
    state2, hist2 = train_loop.train(model, opt, pipe2, NVCacheFS(nv2), total_steps=20,
                                     ckpt_every=10, device="cpu")
    assert len(hist2) == 3
    assert pipe2.step == 20
    assert int(state2["opt"]["step"]) == 20
    nv2.shutdown()

    _, nv3, _, _, pipe3 = _setup()
    state3, _ = train_loop.train(model, opt, pipe3, NVCacheFS(nv3), total_steps=20,
                                 ckpt_every=10, device="cpu")
    for a, b in zip(tree_leaves(state2), tree_leaves(state3)):
        assert torch.equal(a, b)
    nv3.shutdown()


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m", "hymba-1.5b"])
def test_train_step_with_compression_matches_jax(np_params, arch):
    """One whole train step from shared parameters, compressed gradients:
    loss before the step and parameters after it agree with JAX's (the SSM
    and hybrid families through the SSD scan's backward: on the CPU its
    plain version, autograd through ``ssd_ref``)."""
    if arch != ARCH:
        np_params = jax.tree.map(np.asarray, jax_build(jax_smoke(arch)).init(
            jax.random.PRNGKey(0)))
    toks = _tokens(seed=4)
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    from repro.models.registry import build as jbuild
    from repro.train import steps as jsteps
    jstep = jsteps.make_train_step(jbuild(jc), jadamw.AdamW(lr=1e-2), compress=True)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate, jmetrics = jstep({"params": jp, "opt": jadamw.AdamW(lr=1e-2).init(jp)},
                             {"tokens": jnp.asarray(toks)})
    opt = AdamW(lr=1e-2)
    params = params_from_numpy(np_params, CPU)
    state = {"params": params, "opt": opt.init(params)}
    metrics = tsteps.make_train_step(build(tc), opt, compress=True)(
        state, {"tokens": torch.from_numpy(toks)})
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-4
    assert abs(float(metrics["grad_norm"]) - float(jmetrics["grad_norm"])) <= 1e-4
    for a, b in zip(tree_leaves(params_to_numpy(state["params"])),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate["params"]))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_launch_train_main_on_cpu(capsys):
    out = launch_train.main(["--smoke", "--steps", "6", "--ckpt-every", "3",
                             "--compress-grads", "--device", "cpu"])
    assert out["steps"] == 6 and out["arch"] == "llama3.2-1b-smoke"
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert '"last_loss"' in capsys.readouterr().out
