"""Mixture-of-Experts layer: the port of ``repro.models.moe``'s
capacity-factor gather/scatter dispatch, and a dropless path of the port's
own.  Without a mesh, and on a mesh where JAX falls back to it,
``moe_forward`` runs the gather path (``_moe_gather``); on a mesh whose
``model`` axis can split the experts and the sequence, it runs expert
parallelism with explicit all-to-alls (``_moe_shard_map``).  The
``pattern`` family runs the dropless path (``_moe_dropless``).

Tokens are cut into groups of ``cfg.moe_group`` (the last one zero-padded),
each token picks its top-k experts from a float32 router softmax, and each
(token, k) pair takes the next slot of its expert's capacity-C queue in
token-major order, the k choices in descending probability; pairs past C are
dropped.  Dispatch and combine are data movement (one gather each, through
index maps), the experts SwiGLU products in the activations' dtype.  The
dispatch buffer is laid out expert-major, ``(E, G, C, d)`` where JAX's is
``(G, E, C, d)``, so each expert product is one batched matmul over E on
views, with no copy of the buffer.  Every function computes what its JAX
namesake does.

Returns the layer output and the Switch load-balancing loss, E · Σ_e f_e p_e
(f_e the fraction of the k choices that went to e, p_e its mean router
probability).  A decode step of B tokens is one group of B with C =
max(4, ...) = 4 here, so it drops nothing (each token takes an expert once),
where a prefill may: forward and decode can differ at dropped pairs, in
JAX as in the port.

The dropless path (NVIDIA Nemotron-H's MoE) routes each token over
``cfg.n_router`` experts by sigmoid scores: it picks the top k by score
plus a correction bias and weighs them by their unbiased scores,
normalised over the k and scaled by ``routed_scale``.  Of the router's
experts, 0..``n_experts``-1 are held here (a card's share of expert
parallelism): a pair routed to another adds nothing, as its part would come
back from the card that holds it.  The held experts are relu² MLPs,
down(relu(up(x))²); a shared expert of the same kind runs on every token.
Every pair on a held expert is computed, with no host sync and no shape
that depends on the routing, so that a decode step can be captured.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import mesh_sizes, placements
from repro_torch.runtime.ranges import span

_drops = None   # while count_drops() is open: each call's dropped pairs, on the device
_routes = None  # while count_routes() is open: each dropless call's (held pairs, top load)
# the profiler ranges of the layer's stages (launch/profile_serve.py reads them;
# the dropless path also opens ``moe.route``, and ``moe.layer`` around all of it,
# which bench/metrics/moe_idle_pct.serve.py reads)
ROUTE_SPAN = "moe.route"
DISPATCH_SPAN = "moe.dispatch"
EXPERTS_SPAN = "moe.experts"
COMBINE_SPAN = "moe.combine"
LAYER_SPAN = "moe.layer"


def moe_init(cfg: ModelConfig, gen: torch.Generator, device):
    """router (d, R) float32 whatever ``cfg.param_dtype`` is, as JAX draws it
    (R = ``cfg.n_router``); the E held experts' wg (SwiGLU, not the
    ``pattern`` family's relu²), wu (E, d, f) and wd (E, f, d) in
    ``cfg.pdt``; the ``pattern`` family's router correction bias
    ``router_bias`` (R,) float32, zero; a shared expert's ``shared_wu`` (d,
    f_s) and ``shared_wd`` (f_s, d)."""
    d, E, f, R = cfg.d_model, cfg.n_experts, cfg.d_expert, cfg.n_router
    p = {"router": dense_init(gen, (d, R), d, torch.float32, device)}
    if cfg.family == "pattern":
        p["router_bias"] = torch.zeros((R,), dtype=torch.float32, device=device)
    else:
        p["wg"] = dense_init(gen, (E, d, f), d, cfg.pdt, device)
    p["wu"] = dense_init(gen, (E, d, f), d, cfg.pdt, device)
    p["wd"] = dense_init(gen, (E, f, d), f, cfg.pdt, device)
    if cfg.d_shared:
        p["shared_wu"] = dense_init(gen, (d, cfg.d_shared), d, cfg.pdt, device)
        p["shared_wd"] = dense_init(gen, (cfg.d_shared, d), cfg.d_shared, cfg.pdt, device)
    return p


def moe_capacity(cfg: ModelConfig, group_len: int) -> int:
    """Slots per expert for a group: group_len · k / E · capacity_factor,
    rounded up to a multiple of 4, at least 4."""
    c = int(group_len * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _top_k(probs, K: int):
    """The K largest probabilities of each row and their experts, in
    descending order, the lower index first among equal ones as
    ``lax.top_k`` orders them: a stable sort, where ``torch.topk`` leaves
    ties unordered (a padding token's uniform probabilities are all ties)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :K], idx[..., :K]


def _route(cfg: ModelConfig, router, xt):
    """Top-k routing of the tokens ``xt`` (..., T, d): (w, idx, aux).  The
    logits are a float32 product (the activations cast up; PyTorch's default
    ``allow_tf32`` False keeps it full fp32 on the card), ``w`` the top-k
    probabilities renormalised to sum to 1, ``idx`` the experts in
    descending probability (``_top_k``), and aux the Switch loss over all
    tokens."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    w, idx = _top_k(probs, K)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    tokens = tuple(range(idx.dim() - 1))
    f_e = F.one_hot(idx, E).float().sum(-2).mean(tokens)
    p_e = probs.mean(tokens)
    return w, idx, E * torch.sum(f_e / K * p_e)


def _slots(idx_f, E: int, C: int):
    """Slot of each (token, k) pair ``idx_f`` (..., T·K) in its expert's
    queue: the number of pairs before it, along the last axis, with the same
    expert.  Returns (slot clamped to C - 1, kept).  JAX counts with a
    cumsum down (T·K, E) one-hot rows; here the count runs along the pairs'
    axis of an (..., E, T·K) mask, a scan over contiguous memory (the other
    layout's scan took 6.4 ms of each qwen3-moe prefill layer on an NVIDIA H100
    80GB HBM3 at 700 W)."""
    idx = idx_f.long()
    hit = idx[..., None, :] == torch.arange(E, device=idx.device)[:, None]
    seen = torch.cumsum(hit, dim=-1, dtype=torch.int32)     # up to and including
    slot = torch.gather(seen, -2, idx[..., None, :])[..., 0, :].long() - 1
    return slot.clamp(max=C - 1), slot < C


# each stage's range is opened at one call site, shared by both paths
# (``tests/test_torch_ranges.py`` holds every range name to one ``span`` call)
def _dispatch_range():
    return span(DISPATCH_SPAN)


def _experts_range():
    return span(EXPERTS_SPAN)


def _combine_range():
    return span(COMBINE_SPAN)


@contextlib.contextmanager
def count_routes():
    """While open, each dropless ``moe_forward`` call outside a CUDA graph's
    capture appends (the (token, k) pairs that landed on held experts, the
    most pairs on one held expert) to the yielded list, as 0-d int32
    tensors on its device (no sync); closed, nothing is counted."""
    global _routes
    outer, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = outer


@contextlib.contextmanager
def count_drops():
    """While open, each ``moe_forward`` call appends the number of (token,
    k) pairs it dropped over capacity to the yielded list, as a 0-d tensor
    on its device (no sync); closed, nothing is counted."""
    global _drops
    outer, _drops = _drops, []
    try:
        yield _drops
    finally:
        _drops = outer


def moe_forward(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (out: (B, S, d) in x.dtype, aux: float32 scalar).

    With a mesh in scope whose ``model`` axis M > 1 divides the experts and
    the sequence, and (B·S)/M >= k, the expert-parallel ``_moe_shard_map``,
    as JAX dispatches; otherwise the gather path, on a mesh over every
    rank's whole copy of the tokens and experts (``_moe_gather_replicated``).
    The ``pattern`` family's dropless path, without a mesh (aux None)."""
    if cfg.family == "pattern":
        if isinstance(x, DTensor):
            raise NotImplementedError("the dropless MoE path runs on one card's share of "
                                      "the experts, not on a mesh")
        with span(LAYER_SPAN):
            return _moe_dropless(cfg, p, x), None
    mesh = pctx.current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return _moe_gather(cfg, p, x)
    M = pctx.model_size(mesh)
    B, S, _ = x.shape
    if M > 1 and cfg.n_experts % M == 0 and S % M == 0 and (B * S) // M >= cfg.top_k:
        return _moe_shard_map(cfg, p, x, mesh, M)
    return _moe_gather_replicated(cfg, p, x)


def _replicated(t):
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _moe_gather_replicated(cfg: ModelConfig, p, x):
    """The gather path under a mesh: the tokens and the experts gathered
    whole on every rank (an all-gather each, where JAX's partitioner would
    shard the gather itself), the same computation as without a mesh on
    each rank, and the output cut back to x's shards (replicated where x
    is a partial sum: a partial placement is DTensor's own to make)."""
    rep = tuple([Replicate()] * x.device_mesh.ndim)
    y, aux = local_map(lambda pl, xl: _moe_gather(cfg, pl, xl), out_placements=(rep, rep),
                       in_placements=(rep,) * 5, device_mesh=x.device_mesh)(
        {k: _replicated(p[k]) for k in ("router", "wg", "wu", "wd")}, _replicated(x))
    return pctx.placed_like(y, x), aux


def _moe_shard_map(cfg: ModelConfig, p, x, mesh, M: int):
    """Expert parallelism with explicit all-to-alls, as JAX's shard_map.

    Tokens are placed with the batch over the data axes and the sequence
    over ``model``, each rank's E / M experts whole on it (the FSDP
    dim gathered), the router on every rank: the in-specs JAX's
    ``shard_map`` reshards to.  Each rank routes its own T tokens at C =
    ``moe_capacity(cfg, T)``, builds its (E, C, d) dispatch buffer, and two
    all-to-alls over the ``model`` group move tokens to their experts' rank
    and back; both carry gradients (``all_to_all_single_autograd``).  aux
    is the mean over all ranks of each rank's own (JAX's ``pmean``)."""
    B, _, d = x.shape
    E = cfg.n_experts
    E_loc = E // M
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    xpl = placements((dp if B % math.prod(sizes[a] for a in dp) == 0 else None,
                      "model", None), mesh)
    epl = placements(("model", None, None), mesh)
    rep = tuple([Replicate()] * mesh.ndim)
    group = mesh.get_group("model")
    n_ranks = mesh.size()

    def exchange(t):
        """t (M, ...): row m to the model axis' rank m; row m of the result
        from rank m."""
        out = funcol.all_to_all_single_autograd(t.reshape(M, -1), None, None, group)
        return out.reshape(t.shape)

    def local(xl, router, wg, wu, wd):
        Bl, Sl, _ = xl.shape
        buf, plan, aux = _dispatch(cfg, router, xl.reshape(1, Bl * Sl, d))   # (E, 1, C, d)
        C = buf.shape[2]
        buf = exchange(buf.view(M, E_loc, C, d))                 # from every rank
        o = _experts(buf.transpose(0, 1).reshape(E_loc, M * C, d), wg, wu, wd)
        o = exchange(o.view(E_loc, M, C, d).transpose(0, 1).contiguous())   # back home
        return _combine(o.view(E, C, d), plan).view(Bl, Sl, d), aux / n_ranks

    # each rank's gradients of the router and of its experts are its own
    # tokens' share: partial sums over the ranks that hold the same copy
    summed = tuple([Partial()] * mesh.ndim)
    esum = tuple(p if a == "model" else Partial() for a, p in zip(mesh.mesh_dim_names, epl))
    y, aux = local_map(local, out_placements=(xpl, summed),
                       in_placements=(xpl, rep, epl, epl, epl),
                       in_grad_placements=(xpl, summed, esum, esum, esum), device_mesh=mesh)(
        x.redistribute(mesh, xpl), _replicated(p["router"]),
        *(p[k].redistribute(mesh, epl) for k in ("wg", "wu", "wd")))
    return y, _replicated(aux)


def _moe_gather(cfg: ModelConfig, p, x):
    """The gather path: x (B, S, d) -> (out (B, S, d), aux).

    Groups of ``min(cfg.moe_group, B·S)`` tokens, C = ``moe_capacity``.
    JAX scatters every pair's token row into a zeroed buffer, adding an
    over-capacity one at slot C - 1 with weight 0 (an exact + 0); here each
    slot gathers its token's row (an empty slot a zero row) from an (E, G,
    C) map of rows into which only the kept pairs are written (a dropped one
    into a spare expert row that is sliced off): the same buffer from one
    gather, with no data-dependent shape and no sync.  Combine gathers each
    pair's output at its clamped slot and sums them over k weighted by w
    (0 where dropped) in one batched product, where JAX multiplies in the
    activations' dtype, then sums."""
    B, S, d = x.shape
    T = B * S
    Tg = min(cfg.moe_group, T)
    xt = x.reshape(T, d)
    pad = (-T) % Tg
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    G = xt.shape[0] // Tg
    buf, plan, aux = _dispatch(cfg, p["router"], xt.view(G, Tg, d))
    E, _, C, _ = buf.shape
    out = _experts(buf.view(E, G * C, d), p["wg"], p["wu"], p["wd"])
    return _combine(out, plan)[:T].reshape(B, S, d), aux


def _dispatch(cfg: ModelConfig, router, xg):
    """Route the groups ``xg`` (G, Tg, d), each at C = ``moe_capacity(cfg,
    Tg)``: returns (the dispatch buffer (E, G, C, d), the plan
    ``_combine`` reads, aux)."""
    G, Tg, d = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, Tg)
    w, idx, aux = _route(cfg, router, xg)                    # (G, Tg, K)
    idx_f = idx.reshape(G, Tg * K)                           # token-major
    slot, keep = _slots(idx_f, E, C)                         # (G, Tg K)
    if _drops is not None:
        _drops.append((~keep).sum())
    group = torch.arange(G, device=xg.device)[:, None].expand(G, Tg * K)
    with _dispatch_range():
        row = group * Tg + torch.arange(Tg * K, device=xg.device) // K
        src = torch.full((E + 1, G, C), G * Tg, dtype=torch.long, device=xg.device)
        src.index_put_((torch.where(keep, idx_f, E), group, torch.where(keep, slot, 0)), row)
        rows = torch.cat([xg.reshape(G * Tg, d), xg.new_zeros((1, d))])
        buf = rows[src[:E]]                                  # (E, G, C, d)
    return buf, (w, idx_f, slot, keep, group), aux


def _experts(h, wg, wu, wd):
    """The experts' SwiGLU over their slots h (E, n, d), in h's dtype."""
    with _experts_range():
        a = F.silu(torch.bmm(h, wg.to(h.dtype))) * torch.bmm(h, wu.to(h.dtype))
        return torch.bmm(a, wd.to(h.dtype))


def _combine(out, plan):
    """Each token's k outputs gathered from ``out`` (E, G·C, d) at their
    slots and summed weighted by w (0 where dropped): (G·Tg, d)."""
    w, idx_f, slot, keep, group = plan
    G, Tg, K = w.shape
    E, d = out.shape[0], out.shape[-1]
    C = out.numel() // (E * G * d)
    with _combine_range():   # one flat index: a vectorized gather
        at = (idx_f * G + group) * C + slot
        wk = (w.to(out.dtype) * keep.view(G, Tg, K)).view(G * Tg, 1, K)
        return torch.bmm(wk, out.reshape(E * G * C, d)[at].view(G * Tg, K, d))


# ------------------------------------------------------------------ dropless

def _route_sigmoid(cfg: ModelConfig, p, xt):
    """Sigmoid routing of the tokens ``xt`` (T, d): (w (T, K) float32, idx
    (T, K)).  The scores are the sigmoid of a float32 product; the k experts
    are the largest by score plus ``router_bias`` (the correction moves the
    choice, not the weight), weighted by their scores normalised to sum to 1
    and scaled by ``routed_scale``."""
    scores = torch.sigmoid(xt.float() @ p["router"].float())
    idx = torch.topk(scores + p["router_bias"].float(), cfg.top_k, dim=-1).indices
    w = scores.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale, idx


def _relu2(x, wu, wd):
    return torch.relu(x @ wu.to(x.dtype)).square() @ wd.to(x.dtype)


def _moe_dropless(cfg: ModelConfig, p, x):
    """The dropless path: x (B, S, d) -> (B, S, d) in x.dtype.

    The N = T·K (token, k) pairs are sorted by expert, those on experts
    held elsewhere last (a stable sort, so each expert's pairs stay in token
    order), each held expert's count taken by a scatter into a fixed
    (E + 1,) vector and its end offset by a cumsum, all on the device.  Each
    projection of the held experts is then one grouped product
    (``torch._grouped_mm``) over the sorted rows at those offsets; it leaves
    the rows past the last offset unwritten.  Combine gathers each pair's
    output back into token order, zeroes the pairs of experts held
    elsewhere, and sums each token's k weighted in one batched product.
    Every shape is fixed by x's."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T, K, E = B * S, cfg.top_k, cfg.n_experts
    with span(ROUTE_SPAN):
        w, idx = _route_sigmoid(cfg, p, xt)
    with _dispatch_range():
        key = idx.reshape(T * K)
        held = key < E
        key = torch.where(held, key, E)           # pairs held elsewhere sort last
        order = torch.argsort(key, stable=True)
        counts = torch.zeros((E + 1,), dtype=torch.int32, device=x.device).scatter_add_(
            0, key, torch.ones_like(key, dtype=torch.int32))
        ends = torch.cumsum(counts[:E], 0, dtype=torch.int32)
        rows = xt.index_select(0, order // K)
    if _routes is not None and not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        _routes.append((ends[-1], counts[:E].max()))
    with _experts_range():
        h = torch._grouped_mm(rows, p["wu"].to(x.dtype), offs=ends)
        del rows
        y = torch._grouped_mm(torch.relu(h).square_(), p["wd"].to(x.dtype), offs=ends)
        del h
    with _combine_range():
        back = torch.empty_like(order).scatter_(
            0, order, torch.arange(T * K, device=x.device))
        yk = y.index_select(0, back).view(T, K, d)
        del y
        yk.masked_fill_(~held.view(T, K, 1), 0)   # rows the products left unwritten
        out = torch.bmm(w.to(x.dtype).view(T, 1, K), yk).view(T, d)
    if cfg.d_shared:
        out = out + _relu2(xt, p["shared_wu"], p["shared_wd"])
    return out.view(B, S, d)
