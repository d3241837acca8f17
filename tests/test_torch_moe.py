"""The port's MoE layer (``repro_torch.models.moe``: capacity, routing,
slots, the gather dispatch and its gradient) against the JAX package's
``repro.models.moe`` for qwen3-moe-30b-a3b and arctic-480b (with its dense
residual MLP) SMOKE, from the same numpy inputs; arctic's head padding;
and decode against forward at dropped pairs, in JAX and in the port.

Routing is discontinuous: a token's top-k set flips where two experts'
probabilities cross.  So each comparison first holds the chosen experts
equal, and prints the smallest gap between a token's k-th and (k+1)-th
probability in its inputs.  Where the two sides route the same input (the
layer tests here) the experts must be equal everywhere.  Where the
frameworks' bfloat16 rounding reaches the router first (the model tests),
``routes_as_jax`` holds them equal wherever JAX's probabilities lie
further apart than twice the largest |Δp| between the two sides' (so that
only rounding can flip or reorder a token's experts), and gives the port
JAX's experts at those few tokens.

Tolerances: float32 1e-5 (the same float32 arithmetic in another order);
bfloat16 outputs 2e-2·(1+|ref|) (the experts' products, the combine and
the weighted sum over k round to bfloat16 at different places on the two
sides; measured below 8.7e-3); weights and aux 1e-5 in both dtypes (the
router product is float32 from the same values); gradients 1e-4·(1+|ref|)
in float32."""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
CPU = torch.device("cpu")
# the largest |Δp| ``routes_as_jax`` takes between the port's and JAX's
# router probabilities in a model test: float32 sums in another order;
# bfloat16 activations rounded at other places before the router (measured
# up to 5.3e-3 at SMOKE size)
ROUTER_DP = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- routes

def _gap(probs, K):
    """Each token's k-th minus (k+1)-th largest probability."""
    s = -np.sort(-np.asarray(probs, np.float64), -1)
    return s[..., K - 1] - s[..., K]


def _order_gap(probs, K):
    """Each token's smallest gap between neighbours among its k + 1 largest
    probabilities: what rounding must cross to change its ordered top-k
    (the set, or the order of the k choices, which sets their slots)."""
    s = -np.sort(-np.asarray(probs, np.float64), -1)[..., :K + 1]
    return (s[..., :-1] - s[..., 1:]).min(-1)


def min_gap(routes, K):
    """The smallest positive gap over the recorded routes (exact ties are
    a padding token's uniform probabilities, routed alike on both sides)."""
    gaps = np.concatenate([_gap(p, K).ravel() for _, p in routes])
    return float(gaps[gaps > 0].min())


@contextlib.contextmanager
def jax_routes():
    """Record (experts, probabilities) of each ``lax.top_k`` the JAX model
    takes (its MoE routers), in program order, as numpy arrays."""
    out, orig = [], jax.lax.top_k

    def spy(x, k):
        w, i = orig(x, k)
        jax.debug.callback(lambda i_, x_: out.append((np.asarray(i_), np.asarray(x_))), i, x,
                           ordered=True)
        return w, i

    jax.lax.top_k = spy
    try:
        yield out
    finally:
        jax.lax.top_k = orig


@contextlib.contextmanager
def routes_as_jax(recorded, max_dp):
    """While open, each of the port's ``_top_k`` calls is held to the JAX
    route of the same layer and tokens (the recorded call of that shape
    whose probabilities lie nearest; |Δp| at most ``max_dp``).  Where the
    ordered experts differ, JAX's gaps between neighbours among its k + 1
    largest probabilities must come within twice that call's largest |Δp|
    somewhere (``_order_gap``), so that the rounding of the two sides alone
    can have flipped them, and there the port takes JAX's experts with its
    own probabilities.
    Yields a report: calls, tokens given JAX's experts, largest |Δp|."""
    report = {"calls": 0, "forced": 0, "max_dp": 0.0}
    orig = tmoe._top_k

    def held(probs, K):
        w, idx = orig(probs, K)
        p = probs.detach().cpu().numpy()
        cands = [(float(np.abs(p - jp).max()), ji, jp) for ji, jp in recorded
                 if jp.shape == p.shape]
        assert cands, f"no JAX route of shape {p.shape}"
        dp, ji, jp = min(cands, key=lambda c: c[0])
        assert dp <= max_dp, f"router probabilities {dp:.3e} apart"
        differ = (idx.cpu().numpy() != ji).any(-1)
        assert (_order_gap(jp, K)[differ] <= 2 * dp).all(), "experts differ beyond the rounding"
        report["calls"] += 1
        report["forced"] += int(differ.sum())
        report["max_dp"] = max(report["max_dp"], dp)
        if differ.any():
            idx = torch.from_numpy(ji.copy()).to(idx.device, idx.dtype)
            w = torch.gather(probs, -1, idx)
        return w, idx

    tmoe._top_k = held
    try:
        yield report
    finally:
        tmoe._top_k = orig


# ------------------------------------------------------------- helpers

def _cfgs(arch, compute_dtype="float32", **kw):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype=compute_dtype, **kw),
            dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype, **kw))


@functools.lru_cache(maxsize=None)
def _layer0(cfg):
    """Layer 0's MoE parameters as JAX draws them, numpy (not to be written)."""
    params = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["moe"])


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.detach().float().numpy()


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d <= tol * (1 + np.abs(want))).all(), float(d.max())


# ---------------------------------------------------------------- layer

@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cfg in (get_smoke(arch), get_config(arch),
                dataclasses.replace(get_smoke(arch), capacity_factor=4.0)):
        for group_len in (1, 4, 7, 48, 64, 2048):
            assert tmoe.moe_capacity(cfg, group_len) == jmoe.moe_capacity(cfg, group_len)
    # qwen3-moe's prefill group of 2048: 160 slots for a mean load of 128
    assert tmoe.moe_capacity(get_config("qwen3-moe-30b-a3b"), 2048) == 160


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(arch, dtype):
    """Weights, experts and aux of ``_route`` on the same tokens (T, d)."""
    jc, tc = _cfgs(arch, dtype)
    router = _layer0(jc)["router"]
    jx, tx = _x((96, jc.d_model), dtype, seed=1)
    jw, jidx, jaux = jmoe._route(jc, jnp.asarray(router), jx)
    w, idx, aux = tmoe._route(tc, torch.from_numpy(router.copy()), tx)
    probs = np.asarray(jax.nn.softmax(jx.astype(jnp.float32) @ router, -1))
    print(f"{arch} {dtype}: min gap {float(_gap(probs, tc.top_k).min()):.3e}")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert w.dtype == aux.dtype == torch.float32
    _close(w, jw, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5


def test_top_k_orders_ties_as_jax():
    """Equal probabilities (a zero padding token's) go lower index first."""
    probs = np.full((3, 8), 0.125, np.float32)
    probs[1, 5] = 0.5
    w, idx = tmoe._top_k(torch.from_numpy(probs), 3)
    jw, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("C", [1, 5, 40])
def test_slots_match_jax(C):
    """40 (token, k) pairs over 8 experts: each expert's queue in order,
    pairs past C clamped to slot C - 1 and not kept."""
    idx_f = np.random.default_rng(C).integers(0, 8, size=(40,)).astype(np.int32)
    slot, keep = tmoe._slots(torch.from_numpy(idx_f), 8, C)
    jslot, jkeep = jmoe._slots(jnp.asarray(idx_f), 8, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool((~keep).any()) == (C < np.bincount(idx_f).max())


def _moe_case(arch, dtype, capacity, seed=2):
    """moe_forward of both sides on the same (2, 48, d) input: 96 tokens in
    groups of 64 (the last half padding), with JAX's routes recorded.
    Returns (port out, aux, dropped pairs), (JAX out, aux), routes, cfg."""
    jc, tc = _cfgs(arch, dtype, capacity_factor=capacity)
    p = _layer0(jc)
    jx, tx = _x((2, 48, jc.d_model), dtype, seed=seed)
    with jax_routes() as routes:
        jy, jaux = jmoe.moe_forward(jc, jax.tree.map(jnp.asarray, p), jx)
        jax.effects_barrier()
    with tmoe.count_drops() as drops:
        y, aux = tmoe.moe_forward(tc, params_from_numpy(p, CPU), tx)
    return (y, aux, int(sum(drops))), (jy, jaux), routes, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("drops", [True, False])
def test_moe_forward_matches_jax(arch, dtype, tol, drops):
    """With ``capacity_factor`` 1.25 (20 slots a group of 64 for a mean
    load of 16) some pairs are dropped; with E / k (64 slots) none is."""
    E, K = get_smoke(arch).n_experts, get_smoke(arch).top_k
    (y, aux, dropped), (jy, jaux), routes, tc = _moe_case(arch, dtype, 1.25 if drops else E / K)
    with routes_as_jax(routes, 1e-6) as report:
        y2, _ = tmoe.moe_forward(tc, params_from_numpy(_layer0(_cfgs(arch, dtype)[0]), CPU),
                                 _x((2, 48, tc.d_model), dtype, seed=2)[1])
    print(f"{arch} {dtype} capacity {tc.capacity_factor}: {dropped} pairs dropped, min gap "
          f"{min_gap(routes, K):.3e}, routes {report}")
    assert report["calls"] == 1 and report["forced"] == 0
    assert torch.equal(y2, y)
    assert (dropped > 0) == drops
    assert y.dtype == tc.cdt and y.shape == (2, 48, tc.d_model)
    _close(y, jy, tol)
    assert abs(float(aux) - float(jaux)) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_jax(arch):
    """The gradient of sum(out · r) + 0.01 aux with respect to the router,
    wg, wu, wd and the input against ``jax.grad``, float32, with pairs
    dropped (a dropped pair carries no gradient on either side)."""
    jc, tc = _cfgs(arch)
    p = _layer0(jc)
    x = np.random.default_rng(3).normal(size=(2, 48, jc.d_model)).astype(np.float32)
    r = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(jc, p, x)
        return jnp.sum(y * r) + 0.01 * aux

    jgrads = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = params_from_numpy(p, CPU)
    tx = torch.from_numpy(x).requires_grad_()
    for t in tp.values():
        t.requires_grad_()
    y, aux = tmoe.moe_forward(tc, tp, tx)
    loss = (y * torch.from_numpy(r)).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)] + [tx])
    want = [jgrads[0][k] for k in sorted(tp)] + [jgrads[1]]
    for g, w in zip(grads, want):
        _close(g, w, 1e-4)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("pad_heads_to", [0, 16])
@pytest.mark.parametrize("tp_repeat_kv", [True, False])
def test_arctic_head_padding_changes_nothing(pad_heads_to, tp_repeat_kv):
    """The JAX model pads arctic-480b's heads to a multiple of
    ``pad_heads_to`` (56 to 64; SMOKE's 4 to 16 here) and repeats the kv
    heads to H for the mesh; the port runs the SMOKE heads on their kv
    heads as they are.  Same logits and aux either way (float32)."""
    jc, tc = _cfgs("arctic-480b", pad_heads_to=pad_heads_to, tp_repeat_kv=tp_repeat_kv)
    params = jax.tree.map(np.asarray, jlm.init_lm(jc, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(5).integers(1, jc.vocab - 1, size=(2, 24)).astype(np.int32)
    want, jaux = jlm.forward(jc, params, jnp.asarray(toks))
    got, aux = tlm.forward(tc, params_from_numpy(params, CPU), torch.from_numpy(toks))
    _close(got, want, 1e-4)
    assert abs(float(aux) - float(jaux)) <= 1e-5


def _decode_vs_forward(jc, tc, S=64):
    """Teacher-forced decode against the forward over S tokens of one row
    (one group of S, capacity from the config), JAX and port from the same
    parameters: max |logit gap| per token of each side, and port vs JAX."""
    params = jax.tree.map(np.asarray, jlm.init_lm(jc, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(6).integers(1, jc.vocab - 1, size=(1, S)).astype(np.int32)
    jfull, _ = jax.jit(lambda p, t: jlm.forward(jc, p, t))(params, jnp.asarray(toks))
    _, jcache = jax.jit(lambda p, t: jlm.prefill(jc, p, t, S + 2))(params, jnp.asarray(toks[:, :1]))
    jstep = jax.jit(lambda p, c, t: jlm.decode_step(jc, p, c, t))
    tp, tt = params_from_numpy(params, CPU), torch.from_numpy(toks)
    with tmoe.count_drops() as drops:
        tfull, _ = tlm.forward(tc, tp, tt)
    _, tcache = tlm.prefill(tc, tp, tt[:, :1], S + 2)
    jouts, touts = [], []
    for t in range(1, S):
        lg, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        jouts.append(np.asarray(lg[:, 0]))
        lg, tcache = tlm.decode_step(tc, tp, tcache, tt[:, t:t + 1])
        touts.append(lg[:, 0].numpy())
    jgap = np.abs(np.stack(jouts, 1) - np.asarray(jfull)[:, 1:]).max(-1)[0]
    tgap = np.abs(np.stack(touts, 1) - tfull[:, 1:].numpy()).max(-1)[0]
    return jgap, tgap, float(np.abs(tfull.numpy() - np.asarray(jfull)).max()), int(sum(drops))


def test_decode_differs_from_forward_at_dropped_pairs_in_jax_too():
    """qwen3-moe SMOKE, float32, one row of 64 tokens.  At capacity 1.25
    (20 slots) the forward drops pairs and a decode step (one token: 4
    slots, nothing dropped) does not, so decode leaves the forward at the
    tokens that lost an expert, in JAX as in the port; at E / k (64 slots)
    nothing is dropped and decode equals the forward.  The port follows JAX
    either way: its forward within 1e-4 of JAX's, its decode gap where JAX's
    is.  ``chip_smoke.py`` phase 4 therefore checks decode at E / k."""
    arch = "qwen3-moe-30b-a3b"
    for capacity in (1.25, 4.0):
        jc, tc = _cfgs(arch, capacity_factor=capacity)
        jgap, tgap, port_vs_jax, dropped = _decode_vs_forward(jc, tc)
        print(f"capacity {capacity}: {dropped} pairs dropped, JAX decode gap max "
              f"{jgap.max():.3e} at {int((jgap > 1e-3).sum())} tokens, port {tgap.max():.3e}")
        assert port_vs_jax <= 1e-4
        np.testing.assert_allclose(tgap, jgap, atol=1e-4)
        if capacity == 1.25:
            assert dropped > 0 and jgap.max() > 1e-2
        else:
            assert dropped == 0 and jgap.max() < 1e-4


def test_one_card_configs_of_the_moe_archs():
    """qwen3-moe-30b-a3b serves on one card with bfloat16 parameters
    (30.53 B: 56.9 GiB, its float32 113.7 GiB do not fit), its router kept
    float32 as JAX draws it; arctic-480b (~477 B) has no one-card config
    and ``profile_serve`` leaves it out of its default list."""
    from repro_torch.launch import profile_serve
    cfg = profile_serve.one_card_config("qwen3-moe-30b-a3b")
    assert cfg.param_dtype == "bfloat16" and cfg.n_layers == 48
    assert cfg.param_count() == get_config("qwen3-moe-30b-a3b").param_count()
    assert 30.5e9 < cfg.param_count() < 30.6e9
    layer = tlm._layer_init(dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"),
                                                param_dtype="bfloat16"),
                            torch.Generator(CPU).manual_seed(0), CPU)
    assert layer["moe"]["router"].dtype == torch.float32 and "mlp" not in layer
    assert layer["moe"]["wg"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="arctic-480b"):
        profile_serve.one_card_config("arctic-480b")
    assert get_config("arctic-480b").param_count() > 470e9
    assert profile_serve.one_card_config("llama3.2-1b") == get_config("llama3.2-1b")


def test_random_weights_collapse_the_routing_with_depth():
    """Random weights route the tokens of a prompt more and more alike with
    depth (the attention output, a mean over keys, is a part every token's
    router input shares), so at capacity 1.25 the later layers drop most
    (token, k) pairs: qwen3-moe's 128 experts, top 8 and groups of 2048 at
    d_model 64 and 12 layers, one prompt of 2048 tokens.  The drops are the
    model's, not the dispatch's: the layer matches JAX with drops above.
    A trained router spreads its load; ``chip_smoke.py`` prints the
    full-width model's drops by layer."""
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"), n_layers=12, n_experts=128,
                              top_k=8, moe_group=2048, d_expert=32, vocab=1024, attn_block=1024)
    params = tlm.init_lm(cfg, torch.Generator(CPU).manual_seed(0))
    toks = torch.randint(1, cfg.vocab - 1, (1, 2048), generator=torch.Generator(CPU).manual_seed(1))
    with torch.inference_mode(), tmoe.count_drops() as drops:
        tlm.forward(cfg, params, toks)
    share = [int(n) / (2048 * cfg.top_k) for n in drops]
    print("dropped share by layer", [round(s, 3) for s in share])
    assert len(share) == cfg.n_layers
    assert share[0] < 0.3 and min(share[4:]) > 0.5
