"""Attention modules: GQA/MQA with optional sliding window.

MLA (multi-head latent attention) comes with the slice that ports the
MiniCPM3 family."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_rope, decode_attention, dense_init


# =============================================================== GQA / MQA

def gqa_init(cfg: ModelConfig, gen: torch.Generator):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, H * hd), d, cfg.pdt),
        "wk": dense_init(gen, (d, KV * hd), d, cfg.pdt),
        "wv": dense_init(gen, (d, KV * hd), d, cfg.pdt),
        "wo": dense_init(gen, (H * hd, d), H * hd, cfg.pdt),
    }


def _qkv(cfg, p, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, KV, hd)
    return q, k, v


def gqa_forward(cfg: ModelConfig, p, x, rope=None, *, causal=True, window=None,
                return_kv=False):
    """Full-sequence path (train / prefill).  ``rope``: (cos, sin) or None."""
    q, k, v = _qkv(cfg, p, x)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # The JAX version's tp_repeat_kv, pad_heads_to and sharding constraints
    # only steer how heads are split across a mesh; on one device they change
    # nothing, so the kernel takes the compact KV heads (GQA) as they are.
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            scale=1.0 / (cfg.head_dim ** 0.5))
    out = o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)
    if return_kv:
        return out, (k, v)
    return out


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
    idx = torch.as_tensor(pos, device=kc.device).reshape(1).long()
    kc.index_copy_(1, idx, k.to(kc.dtype))
    vc.index_copy_(1, idx, v.to(vc.dtype))
    o = decode_attention(q, kc, vc, pos=pos, window=window)
    out = o.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype)
    return out, kc, vc
