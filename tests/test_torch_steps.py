"""The port's step builders (``repro_torch.train.steps``) against the JAX
package's: ``abstract_train_state`` key for key, shape for shape and dtype
for dtype for every arch at full width (with the JAX dry run's optimizer:
bf16 moments where the parameters are bf16), and ``make_prefill_step``
then three ``make_serve_step`` steps from the same parameters (drawn by
JAX, carried over through ``repro_torch.convert``) and the same numpy
tokens (and frames), at SMOKE size in float32: logits and caches within
1e-4, ``tests/test_torch_lm.py``'s float32 tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import registry as jreg
from repro.models.registry import build as jax_build
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import steps as jsteps
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.launch.dryrun import optimizer_for
from repro_torch.models.registry import build
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import steps as tsteps

CPU = torch.device("cpu")
SERVED = ("llama3.2-1b", "mamba2-780m", "hymba-1.5b", "minicpm3-4b", "qwen3-moe-30b-a3b",
          "whisper-small")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", treg.all_archs())
def test_abstract_train_state_matches_jax(arch):
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    opt = optimizer_for(cfg)
    got = flatten(tsteps.abstract_train_state(build(cfg), opt))
    want, _ = jax_flatten(jsteps.abstract_train_state(
        jax_build(jcfg), JaxAdamW(moment_dtype=opt.moment_dtype)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, leaf), (_, spec) in zip(got, want):
        assert leaf.device.type == "meta", key
        assert tuple(leaf.shape) == tuple(spec.shape), key
        assert str(leaf.dtype).removeprefix("torch.") == str(spec.dtype), key
    n = sum(leaf.numel() for leaf in tree_leaves(tsteps.abstract_train_state(
        build(cfg), opt)["params"]))
    assert n == sum(int(np.prod(s.shape)) for k, s in want if k.startswith("params/"))


def test_init_on_meta_allocates_and_draws_nothing():
    """A meta init leaves the generator where it was; the same generator's
    CPU init then draws the parameters it always drew."""
    model = build(treg.get_smoke("llama3.2-1b"))
    gen = torch.Generator(CPU).manual_seed(0)
    params = model.init(gen, "meta")
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert torch.equal(gen.get_state(), torch.Generator(CPU).manual_seed(0).get_state())
    own = model.init(gen)
    again = model.init(torch.Generator(CPU).manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own), tree_leaves(again)))


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab - 1, size=(B, S)).astype(np.int32)
    if cfg.family != "encdec":
        return {"tokens": toks}
    frames = rng.normal(size=(B, 24, cfg.d_model)).astype(np.float32)
    return {"frames": frames, "dec_tokens": toks}


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_serve_steps_match_jax_f32(arch):
    jc = dataclasses.replace(jreg.get_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(treg.get_smoke(arch), compute_dtype="float32")
    jm, tm = jax_build(jc), build(tc)
    np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(np_params, CPU)
    S, max_len = 20, 28
    batch = _batch(tc, 2, S, seed=1)
    jlog, jcache = jsteps.make_prefill_step(jm, max_len)(
        np_params, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, tcache = tsteps.make_prefill_step(tm, max_len)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    jserve, tserve = jsteps.make_serve_step(jm), tsteps.make_serve_step(tm)
    for step in range(3):
        nxt = np.random.default_rng(10 + step).integers(1, tc.vocab - 1, size=(2, 1)).astype(
            np.int32)
        jlog, jcache = jserve(np_params, jcache, jnp.asarray(nxt))
        tlog, tcache = tserve(tparams, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog)
    for key in jcache:
        _close(tcache[key], jcache[key])
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + 3
