"""The slices as a whole: greedy serving of llama3.2-1b, mamba2-780m,
minicpm3-4b (MLA: expanded prefill, absorbed latent decode), hymba-1.5b
(hybrid: windowed attention beside an SSM), minitron-8b, granite-20b
(learned positions), qwen2-vl-7b (M-RoPE), qwen3-moe-30b-a3b and arctic-480b
(MoE, arctic with its dense residual MLP) and whisper-small (the
encoder-decoder: 20 zero frames, a decoder prompt of the first 8 tokens,
as ``repro.launch.serve`` builds its batch) SMOKE by the JAX package and
by the port from the same numpy parameters and prompts (20 tokens: not a
multiple of mamba2's or hymba's SMOKE chunk 16, so the sequence padding
runs; past hymba's window 16, so it cuts), and the port's serve entry point with its durable
request log."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models.registry import build as jax_build
from repro_torch.configs.registry import get_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.registry import build

ARCHS = ("llama3.2-1b", "mamba2-780m", "minicpm3-4b", "hymba-1.5b", "minitron-8b",
         "granite-20b", "qwen2-vl-7b", "qwen3-moe-30b-a3b", "arctic-480b", "whisper-small")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    threads of the suite's parallel workers would contend for the cores
    (a 52-layer decode loop ran ~200x slower with six workers of eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_generate(model, params, prompts, n_tokens):
    """The loop of ``repro.launch.serve.main``, its batch included."""
    B, P = prompts.shape
    max_len = P + n_tokens + 8
    if model.cfg.family == "encdec":
        batch = {"frames": jnp.zeros((B, P, model.cfg.d_model), model.cfg.cdt),
                 "dec_tokens": prompts[:, :8]}
    else:
        batch = {"tokens": prompts}
    logits, cache = jax.jit(lambda p, b: model.prefill(p, b, max_len))(params, batch)
    step = jax.jit(model.decode_step)
    out = []
    for _ in range(n_tokens):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(tok)
        logits, cache = step(params, cache, tok)
    return np.asarray(jnp.concatenate(out, 1)), np.asarray(logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_f32(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    jmodel = jax_build(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(0).integers(1, tcfg.vocab - 1, size=(3, 20)).astype(np.int32)
    want, want_logits = _jax_generate(jmodel, np_params, jnp.asarray(prompts), 10)
    with torch.inference_mode():
        got, logits, _, _ = serve.generate(build(tcfg), params_from_numpy(np_params, "cpu"),
                                           torch.from_numpy(prompts), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_logs_requests_durably(capsys, arch):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "12", "--tokens", "5", "--seed", "3"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["arch"] == get_smoke(arch).arch and printed["batch"] == 2
    assert printed["tokens_per_s"] > 0
    assert printed["sample"] == res.tokens[0, :8].tolist()
    assert res.tokens.shape == (2, 5) and res.tokens.dtype == torch.int32
    assert bool(torch.isfinite(res.logits).all())
    lines = [json.loads(x) for x in res.log.decode().splitlines()]
    assert lines[0] == {"batch": 2, "prompt_len": 12}
    assert lines[1]["completed"] == 10 and lines[1]["seconds"] > 0
    again = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "12", "--tokens", "5", "--seed", "3"])
    assert torch.equal(again.tokens, res.tokens)
