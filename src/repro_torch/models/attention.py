"""Attention modules: GQA/MQA with optional sliding window, and MLA
(multi-head latent attention, MiniCPM3/DeepSeek-V2 style, with the absorbed
decode path serving directly from the compressed latent cache)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope, decode_attention, dense_init, pad_zeros,
                                       rmsnorm, write_rows)
from repro_torch.parallel import context as pctx


# =============================================================== GQA / MQA

def gqa_init(cfg: ModelConfig, gen: torch.Generator, device):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, H * hd), d, cfg.pdt, device),
        "wk": dense_init(gen, (d, KV * hd), d, cfg.pdt, device),
        "wv": dense_init(gen, (d, KV * hd), d, cfg.pdt, device),
        "wo": dense_init(gen, (H * hd, d), H * hd, cfg.pdt, device),
    }


def _qkv(cfg, p, x):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = pctx.split_last(x @ p["wq"].to(x.dtype), H, hd)
    k = pctx.split_last(x @ p["wk"].to(x.dtype), KV, hd)
    v = pctx.split_last(x @ p["wv"].to(x.dtype), KV, hd)
    return q, k, v


def gqa_forward(cfg: ModelConfig, p, x, rope=None, *, causal=True, window=None,
                return_kv=False):
    """Full-sequence path (train / prefill).  ``rope``: (cos, sin) or None."""
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    H = cfg.n_heads
    qa, ka, va = q, k, v
    if pctx.model_size() > 1:
        # The heads are split over the mesh's model axis: as in JAX, the kv
        # heads are repeated to H (each rank's query heads then meet their own
        # kv heads whatever KV is) and the heads padded to ``pad_heads_to``.
        # On one device neither changes anything, so there the kernel takes
        # the compact KV heads (GQA) as they are.
        if cfg.tp_repeat_kv and H > cfg.n_kv_heads:
            ka, va = _repeat_heads(k, H), _repeat_heads(v, H)
        if cfg.pad_heads_to and ka.shape[2] == H and H % cfg.pad_heads_to:
            qa, ka, va = (_pad_heads(t, cfg.pad_heads_to) for t in (qa, ka, va))
    qa = pctx.constrain(qa, ("__dp__", None, "model", None))
    ka = pctx.constrain(ka, ("__dp__", None, "model", None))
    va = pctx.constrain(va, ("__dp__", None, "model", None))
    o = ops.flash_attention(qa, ka, va, causal=causal, window=window,
                            scale=1.0 / (cfg.head_dim ** 0.5))
    out = _merge_heads(o, H) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def _repeat_heads(t, H: int):
    """(B, S, KV, D) -> (B, S, H, D), each kv head repeated H / KV times in
    place (``jnp.repeat`` along the heads)."""
    B, S, KV, D = t.shape
    return t[:, :, :, None, :].expand(B, S, KV, H // KV, D).reshape(B, S, H, D)


def _merge_heads(o, H: int):
    """(B, S, Hp, D) -> (B, S, H·D): the first H heads (the rest are
    ``_pad_heads``' zeros), flattened, then sliced.  Slicing first would
    leave the backward to unflatten a gradient sharded over ``model`` into
    H heads that the axis may not divide (arctic's 56 on 16)."""
    return pctx.merge_last(o)[..., :H * o.shape[-1]]


def _pad_heads(t, multiple: int):
    """Zero heads appended up to a multiple of ``multiple``: a zero query
    head gives zeros, sliced off after attention."""
    return pad_zeros(t, -t.shape[2] % multiple, 2)


def gqa_decode(cfg: ModelConfig, p, x, kc, vc, pos, rope=None, *, window=None):
    """One-token step.  kc/vc: (B, Smax, KV, hd); pos: 0-d tensor or int,
    index of the new token.  Writes the new k/v into the caches at ``pos``
    in place (the JAX version returns updated copies) and returns
    (out, kc, vc)."""
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    write_rows(kc, pos, k)
    write_rows(vc, pos, v)
    o = decode_attention(q, kc, vc, pos=pos, window=window)
    out = o.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype)
    return out, kc, vc


# ===================================================================== MLA

def mla_init(cfg: ModelConfig, gen: torch.Generator, device):
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (d, qr), d, cfg.pdt, device),
        "q_norm": torch.ones((qr,), dtype=cfg.pdt, device=device),
        "wq_b": dense_init(gen, (qr, H * (nd + rd)), qr, cfg.pdt, device),
        "wkv_a": dense_init(gen, (d, kvr + rd), d, cfg.pdt, device),
        "kv_norm": torch.ones((kvr,), dtype=cfg.pdt, device=device),
        "wkv_b": dense_init(gen, (kvr, H * (nd + vd)), kvr, cfg.pdt, device),
        "wo": dense_init(gen, (H * vd, d), H * vd, cfg.pdt, device),
    }


def _mla_q(cfg, p, x, rope):
    H, nd, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = pctx.split_last(ql @ p["wq_b"].to(x.dtype), H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    if rope is not None:
        cos, sin = rope
        q_rope = apply_rope(q_rope, cos[..., :rd // 2], sin[..., :rd // 2])
    return q_nope, q_rope


def _mla_latent(cfg, p, x, rope):
    rd = cfg.qk_rope_dim
    kv = x @ p["wkv_a"].to(x.dtype)
    ckv = rmsnorm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:][:, :, None, :]     # one shared head
    if rope is not None:
        cos, sin = rope
        k_rope = apply_rope(k_rope, cos[..., :rd // 2], sin[..., :rd // 2])
    return ckv, k_rope[:, :, 0, :]


def mla_forward(cfg: ModelConfig, p, x, rope=None, *, causal=True, return_kv=False):
    """Train/prefill: expand the latent to per-head K/V (standard MLA math).
    Attention runs at q/k head dim nd + rd and v head dim vd, v as the
    strided view ``kvb[..., nd:]`` it is (the kernel reads it in place)."""
    B, S, _ = x.shape
    H, nd, rd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    ckv, k_rope = _mla_latent(cfg, p, x, rope)
    kvb = pctx.split_last(ckv @ p["wkv_b"].to(x.dtype), H, nd + vd)
    k_nope, v = kvb[..., :nd], kvb[..., nd:]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], -1)
    # On a mesh the heads are padded to ``pad_heads_to`` so that they split
    # over the model axis, as in JAX; on one device that changes nothing, so
    # there the kernel takes the H heads as they are.
    if pctx.model_size() > 1 and cfg.pad_heads_to and H % cfg.pad_heads_to:
        q, k, v = (_pad_heads(t, cfg.pad_heads_to) for t in (q, k, v))
    q = pctx.constrain(q, ("__dp__", None, "model", None))
    k = pctx.constrain(k, ("__dp__", None, "model", None))
    v = pctx.constrain(v, ("__dp__", None, "model", None))
    o = ops.flash_attention(q, k, v, causal=causal, scale=1.0 / ((nd + rd) ** 0.5))
    out = _merge_heads(o, H) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (ckv, k_rope)
    return out


def mla_decode(cfg: ModelConfig, p, x, ckv_c, krope_c, pos, rope=None):
    """Absorbed decode: attention runs in the compressed latent space, so the
    cache is (kv_lora + rope) per token instead of 2·H·head_dim, the MLA
    serving advantage.  ckv_c: (B, Smax, kvr); krope_c: (B, Smax, rd),
    written at ``pos`` in place (the JAX version returns updated copies).
    Returns (out, ckv_c, krope_c)."""
    B = x.shape[0]
    H, nd, rd, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x, rope)               # (B,1,H,nd/rd)
    ckv, k_rope = _mla_latent(cfg, p, x, rope)             # (B,1,kvr), (B,1,rd)
    write_rows(ckv_c, pos, ckv)
    write_rows(krope_c, pos, k_rope)
    # absorb W^{kv_b}'s K half into the query
    wkvb = pctx.split_last(p["wkv_b"].to(x.dtype), H, nd + vd)
    wk = wkvb[..., :nd]                                    # (kvr, H, nd)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, wk)     # (B,1,H,kvr)
    q_eff = torch.cat([q_abs, q_rope], -1)                 # (B,1,H,kvr+rd)
    k_eff = torch.cat([ckv_c, krope_c], -1)[:, :, None, :]  # 1 kv head
    o_lat = decode_attention(q_eff, k_eff, ckv_c[:, :, None, :], pos=pos,
                             scale=1.0 / ((nd + rd) ** 0.5))  # (B,1,H,kvr)
    wv = wkvb[..., nd:]                                    # (kvr, H, vd)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, wv)
    out = o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return out, ckv_c, krope_c
