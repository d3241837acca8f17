"""Shared layer primitives: norms (RMSNorm, LayerNorm), RoPE / M-RoPE, SwiGLU MLP, blocked
(flash-style) attention and single-step decode attention, and cache writes
and zero padding that also take DTensors (``parallel/``), in plain PyTorch.

Layouts follow ``repro.models.layers``: activations are ``(B, S, H, D)``
and every reduction runs in float32.  ``blocked_attention`` is the portable
CPU path kept for the tests; on the card the model's attention goes to the
hand-written kernel through ``repro_torch.kernels.ops.flash_attention``."""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel import context as pctx

# --------------------------------------------------------------------- init

def init_device(gen: torch.Generator, device=None) -> torch.device:
    """The device parameters are made on: ``device``, by default the
    generator's.  On ``meta`` nothing is drawn or allocated."""
    return gen.device if device is None else torch.device(device)


def dense_init(gen: torch.Generator, shape, in_dim, dtype, device):
    """Normal(0, 1/in_dim) weights drawn from ``gen`` on ``device``."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x / math.sqrt(in_dim)).to(dtype)


# ------------------------------------------------- cache writes, zero rows

def write_rows(cache, pos, new):
    """``cache[:, pos:pos + n] = new`` in place: cache (B, Smax, ...), new (B,
    n, ...); pos an int, or a 0-d tensor with n = 1 (read on the device: no
    sync).  On a mesh (a DTensor cache) each rank writes its own shard,
    ``new`` placed as the cache but for the sequence, and where the cache
    shards its sequence (``parallel.sharding.cache_specs``' context-parallel
    caches) each rank writes only the rows its block holds: DTensor has no
    rule for ``index_copy_`` in torch 2.11, and a slice assignment into a
    sharded sequence gives wrong rows."""
    if not isinstance(cache, DTensor):
        if isinstance(pos, int):
            cache[:, pos:pos + new.shape[1]] = new
        else:
            idx = torch.as_tensor(pos, device=cache.device).reshape(1).long()
            cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    local = cache.to_local()
    n = new.to(cache.dtype).redistribute(
        mesh, [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl]).to_local()
    shard = 0       # this rank's block of the sequence, mesh dims outer first
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    off, rows = shard * local.shape[1], local.shape[1]
    if isinstance(pos, int):
        lo, hi = max(pos, off), min(pos + n.shape[1], off + rows)
        if hi > lo:
            local[:, lo - off:hi - off] = n[:, lo - pos:hi - pos]
        return
    idx = (pos.full_tensor() if isinstance(pos, DTensor)
           else torch.as_tensor(pos, device=local.device)).reshape(1).long()
    j = idx - off
    inside = (j >= 0) & (j < rows)
    j = j.clamp(0, rows - 1)
    local.index_copy_(1, j, torch.where(inside, n, local.index_select(1, j)))


def pad_zeros(t, n: int, dim: int):
    """``t`` with ``|n|`` zero rows along ``dim``: after it, or before it
    for a negative ``n``.  A concatenation where ``F.pad`` would do: on a
    mesh DTensor's rule for ``constant_pad_nd`` drops a placement in torch
    2.11."""
    zeros = t.new_zeros((*t.shape[:dim], abs(n), *t.shape[dim + 1:]))
    return torch.cat([t, zeros] if n > 0 else [zeros, t], dim=dim)


# --------------------------------------------------------------------- norms

def rmsnorm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------- RoPE

def rope_cos_sin(positions, dim, theta):
    """positions: (..., S) int -> cos/sin (..., S, dim//2) float32."""
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3, dim, theta, sections):
    """Qwen2-VL M-RoPE: positions3 (3, B, S) for (t, h, w); ``sections``
    partitions the dim//2 frequency slots among the three streams, in that
    order.  Returns cos/sin (B, S, dim//2) float32."""
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to dim // 2 = {dim // 2}")
    cos_t, sin_t = rope_cos_sin(positions3, dim, theta)   # (3, B, S, dim//2)
    parts_c, parts_s, start = [], [], 0
    for i, sec in enumerate(sections):
        parts_c.append(cos_t[i, ..., start:start + sec])
        parts_s.append(sin_t[i, ..., start:start + sec])
        start += sec
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) — half-rotation (NeoX)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _decode_attention_on_shards(q, k_cache, v_cache, *, pos, window, scale):
    """:func:`decode_attention` on a mesh, each rank on its own batch rows
    and, where the model axis divides both H and KV, its own heads; the
    caches' sequence whole on every rank (a context-parallel cache is
    gathered for the step, where JAX's partitioner would split the
    softmax).  On local shards because DTensor's rule for the products'
    reshapes refuses a sharded head dim in torch 2.11."""
    heads = q.shape[2] % pctx.model_size() == 0 and k_cache.shape[2] % pctx.model_size() == 0
    axes = ("__dp__", None, "model" if heads else None, None)
    q, k_cache, v_cache = (pctx.constrain(t, axes) for t in (q, k_cache, v_cache))
    pl = tuple(q.placements)
    pos = pos.full_tensor() if isinstance(pos, DTensor) else pos
    fn = functools.partial(decode_attention, pos=pos, window=window, scale=scale)
    return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh)(q, k_cache, v_cache)


# ----------------------------------------------------------------------- MLP

def swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


# ----------------------------------------------- blocked (flash-style) attn

def blocked_attention(q, k, v, *, causal: bool, window=None,
                      block: int = 1024, q_offset=0,
                      kv_len: Optional[int] = None,
                      scale: Optional[float] = None):
    """Online-softmax attention over KV blocks (memory O(S·block)).

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0 (GQA).
    ``q_offset``: global position of q[0] (prefill continuation / decode).
    ``window`` > 0: sliding-window attention (key j visible to query i iff
    i - window < j <= i).  ``kv_len``: valid prefix length of k/v (padding).
    Returns (B, Sq, H, D) in q.dtype.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, D).float()
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    iq = q_offset + torch.arange(Sq, device=dev)
    valid = Skv if kv_len is None else kv_len

    m = torch.full((B, KV, G, Sq), -math.inf, device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, KV, G, Sq, Dv), device=dev)
    for start in range(0, Skv, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        jk = start + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kblk) * scale
        mask = (jk < valid)[None, :].expand(Sq, -1)
        if causal:
            mask = mask & (jk[None, :] <= iq[:, None])
        if window is not None:
            mask = mask & (jk[None, :] > iq[:, None] - window)
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqj,bjkd->bkgqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, pos, window=None,
                     scale: Optional[float] = None):
    """Single-step attention against a cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); ``pos``: (B,), 0-d tensor or
    int — index of the current token, whose k/v the caller has already
    written into the caches (entries ``0..pos`` are valid).
    """
    if isinstance(q, DTensor):
        return _decode_attention_on_shards(q, k_cache, v_cache, pos=pos, window=window,
                                           scale=scale)
    B, _, H, D = q.shape
    _, Smax, KV, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float())
    s = s * (scale if scale is not None else 1.0 / (D ** 0.5))
    j = torch.arange(Smax, device=q.device)
    cur = torch.as_tensor(pos, device=q.device).broadcast_to((B,))
    mask = j[None, :] <= cur[:, None]
    if window is not None:
        mask = mask & (j[None, :] > (cur[:, None] - window))
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)
