"""Mixture-of-Experts layer with capacity-factor gather/scatter dispatch:
the port of ``repro.models.moe``'s gather path (``moe_forward`` without a
mesh, ``_moe_gather``; the shard_map expert parallelism comes with the
distribution slice).

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
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init

_drops = None   # while count_drops() is open: each call's dropped pairs, on the device


def moe_init(cfg: ModelConfig, gen: torch.Generator, device):
    """router (d, E) float32 whatever ``cfg.param_dtype`` is, as JAX draws it;
    the experts' wg, wu (E, d, f) and wd (E, f, d) in ``cfg.pdt``."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    return {"router": dense_init(gen, (d, E), d, torch.float32, device),
            "wg": dense_init(gen, (E, d, f), d, cfg.pdt, device),
            "wu": dense_init(gen, (E, d, f), d, cfg.pdt, device),
            "wd": dense_init(gen, (E, f, d), f, cfg.pdt, device)}


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
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    Tg = min(cfg.moe_group, T)
    xt = x.reshape(T, d)
    pad = (-T) % Tg
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    G = xt.shape[0] // Tg
    xg = xt.view(G, Tg, d)
    C = moe_capacity(cfg, Tg)

    w, idx, aux = _route(cfg, p["router"], xg)               # (G, Tg, K)
    idx_f = idx.reshape(G, Tg * K)                           # token-major
    slot, keep = _slots(idx_f, E, C)                         # (G, Tg K)
    if _drops is not None:
        _drops.append((~keep).sum())
    group = torch.arange(G, device=x.device)[:, None].expand(G, Tg * K)
    with record_function("moe.dispatch"):   # spans launch.profile_serve reads
        row = group * Tg + torch.arange(Tg * K, device=x.device) // K
        src = torch.full((E + 1, G, C), G * Tg, dtype=torch.long, device=x.device)
        src.index_put_((torch.where(keep, idx_f, E), group, torch.where(keep, slot, 0)), row)
        rows = torch.cat([xg.reshape(G * Tg, d), xg.new_zeros((1, d))])
        buf = rows[src[:E]]                                  # (E, G, C, d)
    with record_function("moe.experts"):
        h = buf.view(E, G * C, d)
        a = F.silu(torch.bmm(h, p["wg"].to(x.dtype))) * torch.bmm(h, p["wu"].to(x.dtype))
        out = torch.bmm(a, p["wd"].to(x.dtype))              # (E, G C, d)
    with record_function("moe.combine"):   # one flat index: a vectorized gather
        at = (idx_f * G + group) * C + slot
        wk = (w.to(x.dtype) * keep.view(G, Tg, K)).view(G * Tg, 1, K)
        y = torch.bmm(wk, out.view(E * G * C, d)[at].view(G * Tg, K, d))
    return y.reshape(G * Tg, d)[:T].reshape(B, S, d), aux
