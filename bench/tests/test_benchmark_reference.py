"""The benchmark's plain reference against the program at SMOKE sizes on
the CPU, both in float32: the weights' layout, the SSD scan, the int8
groups, the forward's logits, the loss's gradient and greedy serving
through the cache.  The reference is written apart from the program; the
tests are where the two meet."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.reference import model as ref
from bench.reference import serve as ref_serve
from bench.reference import ssd as ref_ssd
from bench.reference import train as ref_train
from bench.reference.weights import draw, flat_items, leaf_specs

ARCHS = ("mamba2-780m", "hymba-1.5b")
SEED = 2**31 + 4099


def smoke(arch, **kw):
    from repro_torch.configs.registry import get_smoke
    cfg = dataclasses.replace(get_smoke(arch), **kw)
    m = dataclasses.asdict(cfg)
    m["global_layers"] = list(m["global_layers"])
    return cfg, m


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_weights_have_the_programs_layout(arch, size):
    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.models import lm
    cfg = (get_smoke if size == "smoke" else get_config)(arch)
    shapes = {k: tuple(v.shape) for k, v in flat_items(
        lm.init_lm(cfg, torch.Generator().manual_seed(0), "meta"))}
    assert shapes == {k: v[0] for k, v in leaf_specs(dataclasses.asdict(cfg)).items()}


def test_weights_are_a_function_of_the_seed():
    _, m = smoke("hymba-1.5b")
    a, b, c = draw(m, SEED, "cpu"), draw(m, SEED, "cpu"), draw(m, SEED + 1, "cpu")
    for (k, x), (_, y), (_, z) in zip(flat_items(a), flat_items(b), flat_items(c)):
        assert torch.equal(x, y), k
        if leaf_specs(m)[k][1] in ("normal", "dt_bias"):
            assert not torch.equal(x, z), k


def test_ssd_matches_the_programs_plain_scan():
    from repro_torch.kernels.ref import ssd_ref
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 64, 4, 8, 16
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) - 0.5
    B, C = torch.randn(b, s, 1, n, generator=g), torch.randn(b, s, 1, n, generator=g)
    y = ref_ssd.ssd(x, dt, A, B, C, chunk=16)
    torch.testing.assert_close(y, ssd_ref(x, dt, A, B, C, chunk=16)[0], rtol=1e-5, atol=1e-5)


def test_int8_groups_match_the_programs_plain_quantizer():
    from repro_torch.kernels.ref import dequantize_ref, quantize_ref
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    x[256:512] = 0
    pad = torch.cat([x, x.new_zeros(24)])
    q, s = quantize_ref(pad, group=256)
    want = dequantize_ref(q, s, group=256)[:1000]
    assert torch.equal(ref_train.quantize_dequantize(x, 256), want)


def _tokens(vocab, shape, seed=11):
    return torch.randint(1, vocab - 1, shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_gradient_match_the_program(arch):
    from repro_torch.models.registry import build
    cfg, m = smoke(arch, compute_dtype="float32", remat="none")
    model = build(cfg)
    tokens = _tokens(cfg.vocab, (2, 48))
    params = draw(m, SEED, "cpu")
    logits, _ = model.forward(params, {"tokens": tokens})
    want = ref.unembed(m, params, ref.hidden(m, params, tokens))
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)

    leaves = dict(flat_items(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": tokens})
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_loss, grads = ref_train.grads(m, draw(m, SEED, "cpu"), tokens, row_block=1)
    assert abs(loss.item() - ref_loss) < 1e-5
    for k, g in grads.items():
        torch.testing.assert_close(got[k], g, rtol=1e-3, atol=1e-5, msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_agrees_with_the_reference(arch):
    from repro_torch.launch import serve
    from repro_torch.models.registry import build
    cfg, m = smoke(arch, compute_dtype="float32")
    model = build(cfg)
    params = draw(m, SEED, "cpu")
    prompts = _tokens(cfg.vocab, (2, 40), seed=13)
    with torch.inference_mode():
        logits, cache = serve.prefill(model, params, prompts, 6)
        tokens, _ = serve.decode(model, params, logits, cache, 6)
    for r in range(2):
        gaps = ref_serve.served_gaps(m, params, prompts[r], tokens[r])
        assert float(gaps.max()) < 1e-4
        wrong = tokens[r].clone()
        wrong[3] = (wrong[3] + 1) % cfg.vocab
        assert float(ref_serve.served_gaps(m, params, prompts[r], wrong).max()) > 1e-3


def test_fp8_products_round_both_operands():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    exact, low = a @ w, ref.fp8_mm(a, w)
    err = float((low - exact).norm() / exact.norm())
    assert 1e-3 < err < 0.2
