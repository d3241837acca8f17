"""The ``pattern`` family (NVIDIA Nemotron-H: one mixer a block, Mamba-2,
MoE or GQA attention by ``block_pattern``) against the benchmark's plain
reference (``bench/families/pattern.py``, plain float32 torch written apart
from the program), on the CPU at nemotron-3-nano-30b-a3b's SMOKE size:
blocks ``MEM*EME``, 2 B/C groups, 8 of 16 experts held, top 3, a shared
expert.  Both sides get the same seeded weights (``bench.reference.weights.draw``).

Tolerances, each with its reason:

* ``F32_TOL`` 1e-4 on logits (|logit| up to ~4), where the config computes
  in float32: the two sides sum the same float32 products in other orders
  (the grouped expert products, the chunked scan, blocked attention),
  ~1e-6 apart here.  Computing in bfloat16 instead misses by ~1e-2, which
  ``test_bfloat16_compute_fails_the_float32_tolerance`` holds.
* ``SHARE_TOL`` 1e-5 on an MoE layer's output (|out| ~1): one layer's
  float32 sums in other orders.
* The g = 1 SSM path is held bit for bit (``torch.equal``) to the mixer as
  it was before groups came in (a frozen copy below), for mamba2's and
  hymba's SMOKE configs in both compute dtypes.

On a CUDA card (``cuda``; ``-k card``): the dropless path's grouped
products against the CPU's, decode replayed as CUDA graphs against the
eager loop, and K3 at the model's prefill shape (g 8) against its plain
version."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_config, get_smoke, served_archs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_decode_ref, ssd_ref
from repro_torch.models import lm, moe, ssm
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import pad_zeros, rmsnorm
from repro_torch.models.registry import build

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))     # the benchmark's plain reference

from bench.families import pattern as ref_pattern  # noqa: E402
from bench.reference import model as ref  # noqa: E402
from bench.reference.weights import draw, flat_items, leaf_specs  # noqa: E402

ARCH = "nemotron-3-nano-30b-a3b"
SEED = 2**31 + 1237
F32_TOL = 1e-4
SHARE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    suite's parallel workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> ModelConfig:
    return dataclasses.replace(get_smoke(ARCH), **kw)


def _m(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))   # as a configuration file holds it


def _f32():
    cfg = _cfg(param_dtype="float32", compute_dtype="float32")
    return cfg, _m(cfg), draw(_m(cfg), SEED, "cpu")


def _tokens(B, S, seed=0):
    return torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(seed))


def _ref_logits(m, params, toks):
    return ref.unembed(m, params, ref_pattern.hidden(m, params, toks))


# ---------------------------------------------------------------- program

def test_registered_beside_the_jax_archs():
    assert ARCH in served_archs()
    cfg = get_config(ARCH)
    assert cfg.n_layers == 52 and len(cfg.block_pattern) == 52
    assert (cfg.blocks("M"), cfg.blocks("E"), cfg.blocks("*")) == (23, 23, 6)
    assert cfg.d_inner == 4096 != cfg.ssm_expand * cfg.d_model
    assert 31.5e9 < cfg.param_count() < 31.7e9                    # 31.6 B published
    held = dataclasses.replace(cfg, n_experts=64)
    assert 16.85e9 < held.param_count() < 16.95e9                 # card 0's share
    assert 3.5e9 < cfg.active_param_count() < 3.7e9               # both embeddings counted


@pytest.mark.parametrize("bad, match", [
    (dict(block_pattern="MEM*EMX"), "block_pattern"),
    (dict(block_pattern="MEM*EM"), "block_pattern"),
    (dict(n_experts=17), "hold 1 to 16"),
    (dict(n_experts=0), "hold 1 to 16"),
    (dict(attn_kind="mla"), "GQA"),
])
def test_check_ported_refuses_what_the_pattern_path_lacks(bad, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        lm.check_ported(_cfg(**bad))


@pytest.mark.parametrize("bad", [dict(d_shared=32), dict(router_experts=64)])
def test_the_moe_family_keeps_its_capacity_path(bad):
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"), **bad)
    with pytest.raises(NotImplementedError, match="pattern family"):
        lm.check_ported(cfg)


def test_weights_have_the_programs_layout():
    """The reference's leaves are the program's by path and shape; by dtype
    too, but the embedding, unembedding and final norm, which the reference
    keeps float32 (its shared ``unembed`` multiplies in the leaves' dtype)
    and the program casts where it reads them."""
    for cfg in (get_smoke(ARCH), dataclasses.replace(get_config(ARCH), n_experts=64)):
        prog = {k: (tuple(v.shape), v.dtype) for k, v in flat_items(
            lm.init_lm(cfg, torch.Generator().manual_seed(0), "meta"))}
        specs = leaf_specs(_m(cfg))
        assert {k: v[0] for k, v in specs.items()} == {k: v[0] for k, v in prog.items()}
        kinds = {k: (torch.bfloat16 if s[1].startswith("bf16_") else torch.float32)
                 for k, s in specs.items()}
        top = {"embed", "unembed", "final_norm"}
        assert {k: kinds[k] for k in prog if k not in top} == {
            k: v[1] for k, v in prog.items() if k not in top}
        assert all(kinds[k] == torch.float32 for k in top)


def test_forward_matches_the_reference():
    cfg, m, params = _f32()
    toks = _tokens(2, 40)
    with torch.no_grad():
        got, _ = build(cfg).forward(params, {"tokens": toks})
        want = _ref_logits(m, params, toks)
    assert float((got - want).abs().max()) < F32_TOL


def test_bfloat16_compute_fails_the_float32_tolerance():
    """The same weights computed in bfloat16: the forward misses the
    float32 reference by far more than ``F32_TOL``."""
    cfg, m, params = _f32()
    toks = _tokens(2, 40)
    with torch.no_grad():
        got, _ = build(dataclasses.replace(cfg, compute_dtype="bfloat16")).forward(
            params, {"tokens": toks})
        want = _ref_logits(m, params, toks)
    assert float((got - want).abs().max()) > 10 * F32_TOL


@pytest.mark.parametrize("P", [1, 13, 32])
def test_prefill_then_decode_matches_the_full_forward(P):
    """A prefill of P tokens, then one decode step a token up to 40, each
    position's logits against the reference's full forward at that
    position (logits, not tokens: random weights put near ties first)."""
    cfg, m, params = _f32()
    model = build(cfg)
    toks = _tokens(2, 40, seed=P)
    with torch.no_grad():
        want = _ref_logits(m, params, toks)
        logits, cache = model.prefill(params, {"tokens": toks[:, :P]}, 48)
        got = [logits[:, 0]]
        for t in range(P, 40):
            logits, cache = model.decode_step(params, cache, toks[:, t:t + 1].to(torch.int32))
            got.append(logits[:, 0])
    assert float((torch.stack(got, 1) - want[:, P - 1:]).abs().max()) < F32_TOL
    assert set(cache) == {"pos", "k", "v", "ssm_state", "conv_state"}
    assert cache["k"].shape[0] == 1 and cache["ssm_state"].shape[0] == 3
    assert cache["ssm_state"].dtype == torch.float32 and int(cache["pos"]) == 40


def test_router_by_hand():
    """Selection by score plus bias, weights from the unbiased scores,
    normalised over the k and scaled: logits (2, 1, 0.5, -1) give scores
    (0.881, 0.731, 0.622, 0.269); the bias (-1, 0, 0.5, 0) moves expert 0
    out of the top 2 and expert 2 in, so the top 2 are experts 2 and 1,
    weighted 2.5 · (0.622, 0.731) / 1.354."""
    cfg = ModelConfig(arch="t", family="pattern", n_layers=1, d_model=2, n_heads=1,
                      n_kv_heads=1, d_ff=0, vocab=4, n_experts=4, top_k=2, d_expert=2,
                      block_pattern="E", routed_scale=2.5)
    p = {"router": torch.tensor([[2.0, 1.0, 0.5, -1.0], [0.0, 0.0, 0.0, 0.0]]),
         "router_bias": torch.tensor([-1.0, 0.0, 0.5, 0.0])}
    w, idx = moe._route_sigmoid(cfg, p, torch.tensor([[1.0, 0.0]]))
    s = torch.sigmoid(torch.tensor([2.0, 1.0, 0.5, -1.0]))
    want = {2: 2.5 * s[2] / (s[1] + s[2]), 1: 2.5 * s[1] / (s[1] + s[2])}
    got = dict(zip(idx[0].tolist(), w[0].tolist()))
    assert set(got) == {1, 2}
    assert all(abs(got[e] - float(want[e])) < 1e-6 for e in got)
    m = {"top_k": 2, "routed_scale": 2.5}
    rw, ridx = ref_pattern.route(m, p, torch.tensor([[1.0, 0.0]]), ref.f32_mm)
    assert dict(zip(ridx[0].tolist(), rw[0].tolist())) == pytest.approx(got)


def _moe_layer(m, params, i=0):
    """Block i of the MoE stack's mixer leaves, float32."""
    return {k: v[i].float() for k, v in params["layers"]["moe"]["moe"].items()}


def test_dropless_drops_nothing_at_a_skew_that_overflows_a_capacity():
    """A correction bias that sends every token to expert 0: its load is
    every token, twice the slots a capacity factor of 1.25 gives it, and
    the dropless layer still equals the reference, which computes every
    pair; ``count_routes`` reads the pairs on held experts and the top
    load."""
    cfg, m, params = _f32()
    p = _moe_layer(m, params)
    p["router_bias"] = p["router_bias"].clone()
    p["router_bias"][0] = 10.0
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(3))
    T = x.shape[0] * x.shape[1]
    assert cfg.capacity_factor == 1.25                  # which the dropless path ignores
    assert T > moe.moe_capacity(cfg, T)                 # 64 pairs for 32 slots
    with torch.no_grad(), moe.count_routes() as routes:
        got, aux = moe.moe_forward(cfg, p, x)
        want = ref_pattern.moe(m, p, x, ref.f32_mm)
    assert aux is None
    assert float((got - want).abs().max()) < SHARE_TOL
    _, idx = ref_pattern.route(m, p, x.reshape(T, -1), ref.f32_mm)
    assert len(routes) == 1
    assert int(routes[0][0]) == int((idx < cfg.n_experts).sum())
    assert int(routes[0][1]) == T


def test_expert_share_halves_sum_to_the_uncut_layer():
    """The uncut layer (16 experts held) against card 0's share (experts
    0-7) plus card 1's (experts 8-15, held by the program as its 0-7 with
    the router's columns turned to match), the shared expert, which both
    cards compute, counted once."""
    cfg, m, params = _f32()
    whole = _cfg(param_dtype="float32", compute_dtype="float32", n_experts=16)
    mw = _m(whole)
    pw = _moe_layer(mw, draw(mw, SEED, "cpu"), i=1)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(5))
    turn = torch.cat([torch.arange(8, 16), torch.arange(8)])
    card0 = {**pw, "wu": pw["wu"][:8], "wd": pw["wd"][:8]}
    card1 = {**pw, "wu": pw["wu"][8:], "wd": pw["wd"][8:], "router": pw["router"][:, turn],
             "router_bias": pw["router_bias"][turn]}
    xt = x.reshape(-1, cfg.d_model)
    shared = ref_pattern.relu2(xt, pw["shared_wu"], pw["shared_wd"], ref.f32_mm).view(x.shape)
    with torch.no_grad():
        want = ref_pattern.moe(mw, pw, x, ref.f32_mm)
        halves = moe.moe_forward(cfg, card0, x)[0] + moe.moe_forward(cfg, card1, x)[0]
        by_ref = (ref_pattern.routed(mw, card0, xt, ref.f32_mm)
                  + ref_pattern.routed(mw, card1 | {"router": pw["router"],
                                                    "router_bias": pw["router_bias"]},
                                       xt, ref.f32_mm, first=8))
    assert float((halves - shared - want).abs().max()) < SHARE_TOL
    assert float((by_ref.view(x.shape) + shared - want).abs().max()) < SHARE_TOL


def test_count_routes_counts_each_moe_block_and_only_while_open():
    cfg, m, params = _f32()
    model = build(cfg)
    with torch.no_grad():
        with moe.count_routes() as routes:
            model.forward(params, {"tokens": _tokens(1, 16)})
        model.forward(params, {"tokens": _tokens(1, 16)})
    assert len(routes) == cfg.blocks("E") == 3
    assert all(0 <= int(n) <= 16 * cfg.top_k and int(top) <= 16 for n, top in routes)


def test_serving_entry_points_run_the_pattern():
    """``launch/serve.py``'s prefill and decode, greedy, at bf16 compute:
    tokens in range, the eager loop counted (no graph on the CPU)."""
    from repro_torch.launch import decode_graph, serve
    cfg = get_smoke(ARCH)
    model = build(cfg)
    params = draw(_m(cfg), SEED, "cpu")
    before = decode_graph.COUNTS.eager_steps
    with torch.inference_mode():
        logits, cache = serve.prefill(model, params, _tokens(2, 20).to(torch.int32), 4)
        tokens, _ = serve.decode(model, params, logits, cache, 4)
    assert tokens.shape == (2, 4) and 0 <= int(tokens.min()) and int(tokens.max()) < 256
    assert decode_graph.COUNTS.eager_steps - before == 4
    assert cfg.family not in decode_graph.EAGER_FAMILIES


# ------------------------------------------------------- g = 1 unchanged

def _old_ssm_forward(cfg, p, x):
    """``models/ssm.py``'s full-sequence mixer as it was before B/C groups
    (one group, the gated norm over all di channels), one device."""
    di, n, h, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B_, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]
    xBC = ssm.causal_conv(xBC, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs = xBC[..., :di].reshape(B_, S, h, P)
    Bs = xBC[..., di:di + n].reshape(B_, S, 1, n)
    Cs = xBC[..., di + n:].reshape(B_, S, 1, n)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xs_res = xs
    chunk = min(cfg.ssm_chunk, -(-S // 64) * 64)
    pad = (-S) % chunk
    if pad:
        xs, Bs, Cs, dt = (pad_zeros(t, pad, 1) for t in (xs, Bs, Cs, dt))
    y, state = ops.ssd(xs, dt, A, Bs, Cs, chunk=chunk)
    y = y[:, :S] + xs_res * p["D"].to(y.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(B_, S, di) * F.silu(z.float()).to(y.dtype), p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), state


def _old_ssm_decode(cfg, p, x, state, conv_state):
    di, n, h, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B_ = x.shape[0]
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC_new, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]
    window = torch.cat([conv_state, xBC_new], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xBC = F.silu(conv)
    xs = xBC[..., :di].reshape(B_, h, P)
    Bs, Cs = xBC[..., di:di + n].reshape(B_, 1, n), xBC[..., di + n:].reshape(B_, 1, n)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    y, state = ssd_decode_ref(xs, dtv, -torch.exp(p["A_log"].float()), Bs, Cs, state)
    y = (y + xs * p["D"].to(y.dtype)[None, :, None]).reshape(B_, 1, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), state, window[:, 1:]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_one_group_is_bit_equal_to_the_mixer_before_groups(arch, compute):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute)
    assert cfg.ssm_groups == 1
    gen = torch.Generator().manual_seed(11)
    p = ssm.ssm_init(cfg, gen, "cpu")
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen)   # not all zero
    x = torch.randn((2, 37, cfg.d_model), generator=gen).to(cfg.cdt)
    with torch.no_grad():
        out, (state, tail) = ssm.ssm_forward(cfg, p, x, return_state=True)
        old, old_state = _old_ssm_forward(cfg, p, x)
        assert torch.equal(out, old) and torch.equal(state, old_state)
        x1 = torch.randn((2, 1, cfg.d_model), generator=gen).to(cfg.cdt)
        new = ssm.ssm_decode(cfg, p, x1, state, tail)
        for a, b in zip(new, _old_ssm_decode(cfg, p, x1, state, tail)):
            assert torch.equal(a, b)


def test_groups_normalise_apart():
    """The gated norm over g groups is each group's own RMSNorm: scaling
    one group's y leaves the others' outputs as they were."""
    cfg = _cfg(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator().manual_seed(2)
    y, z = (torch.randn((1, 3, cfg.d_inner), generator=gen) for _ in range(2))
    w = torch.rand(cfg.d_inner, generator=gen) + 0.5
    half = cfg.d_inner // cfg.ssm_groups
    y2 = y.clone()
    y2[..., :half] *= 7.0
    a, b = ssm.gated_norm(cfg, y, z, w), ssm.gated_norm(cfg, y2, z, w)
    assert torch.allclose(a[..., half:], b[..., half:])
    # each group scale-free but for the norm's eps (1e-5 against a mean square ~1)
    assert torch.allclose(a[..., :half], b[..., :half], rtol=1e-4, atol=1e-4)
    full = rmsnorm(y * F.silu(z), w, cfg.norm_eps)
    assert not torch.allclose(a, full, atol=1e-3)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped products' fast path, K3 and the "
                    "decode graphs run there only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_dropless_grouped_products_on_the_card(cuda):
    """The dropless layer on the card (bf16 grouped products) against the
    float32 reference of the same bf16 weights and inputs, at the model's
    widths: ||d|| / ||ref|| <= 1e-2, four bf16 roundings in a row (the up
    product, relu², the down product, the weighted sum) of 2^-9 each."""
    cfg = dataclasses.replace(get_config(ARCH), n_experts=64, n_layers=1, block_pattern="E")
    m = _m(cfg)
    params = draw(m, SEED, cuda)
    p = {k: v[0] for k, v in params["layers"]["moe"]["moe"].items()}
    x = torch.randn((4, 256, cfg.d_model), device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        got, _ = moe.moe_forward(cfg, p, x)
        want = ref_pattern.moe(m, {k: v.float() for k, v in p.items()}, x.float(), ref.f32_mm)
    err = float((got.float() - want).norm() / want.norm())
    print(f"dropless layer on the card: ||d|| / ||ref|| {err:.3e}, max |d| / (1 + |ref|) "
          f"{float(((got.float() - want).abs() / (1 + want.abs())).max()):.3e}")
    assert err < 1e-2


def test_decode_graphs_equal_the_eager_loop_on_the_card(cuda):
    """SMOKE size: decode replayed as CUDA graphs (one capture, one replay a
    step) gives the eager loop's tokens and logits bit for bit."""
    from repro_torch.launch import decode_graph, serve
    cfg = get_smoke(ARCH)
    model = build(cfg)
    params = draw(_m(cfg), SEED, cuda)
    toks = _tokens(4, 48).to(cuda).to(torch.int32)
    with torch.inference_mode():
        logits, cache = serve.prefill(model, params, toks, 8)
        before = dataclasses.asdict(decode_graph.COUNTS)
        graphed = serve.decode(model, params, logits.clone(),
                               {k: v.clone() for k, v in cache.items()}, 8)
        after = dataclasses.asdict(decode_graph.COUNTS)
        out, lg, c = [], logits, {k: v.clone() for k, v in cache.items()}
        for _ in range(8):
            tok = torch.argmax(lg[:, -1:], -1).to(torch.int32)
            out.append(tok)
            lg, c = model.decode_step(params, c, tok)
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 8
    assert torch.equal(graphed[0], torch.cat(out, 1)) and torch.equal(graphed[1], lg)


def test_k3_at_the_models_prefill_shape_on_the_card(cuda):
    """K3 at b 16, s 8192, h 64, p 64, g 8, n 128, chunk 128 on views of
    the 6144-wide conv output, as ``ssm_forward`` hands them over, against
    ``ssd_ref`` one batch row at a time: y within one bf16 rounding (2e-2
    of 1 + |ref|), the float32 state 2e-3."""
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_route
    b, s, h, p, g, n, chunk = 16, 8192, 64, 64, 8, 128, 128
    gen = torch.Generator(cuda).manual_seed(0)
    row = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=cuda).to(torch.bfloat16)
    x = row[..., :h * p].unflatten(2, (h, p))
    B = row[..., h * p:h * p + g * n].unflatten(2, (g, n))
    C = row[..., h * p + g * n:].unflatten(2, (g, n))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=cuda) - 3)
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    assert ssd_route(x, B, C, chunk) == "wgmma"
    y, state = ssd_cuda(x, dt, A, B, C, chunk=chunk)
    worst_y = worst_s = 0.0
    for i in range(b):
        wy, ws = ssd_ref(*(t[i:i + 1].float() if t.dim() > 1 else t
                           for t in (x, dt, A, B, C)), chunk=chunk)
        worst_y = max(worst_y, float(((y[i:i + 1].float() - wy).abs() / (1 + wy.abs())).max()))
        worst_s = max(worst_s, float(((state[i:i + 1] - ws).abs() / (1 + ws.abs())).max()))
    print(f"K3 at g 8: max |d| / (1 + |ref|) y {worst_y:.3e}, state {worst_s:.3e}")
    assert worst_y < 2e-2 and worst_s < 2e-3
