"""Whisper-style encoder-decoder backbone: the port of
``repro.models.encdec``.

The audio front end (mel + conv downsampling) is a stub, as in the JAX
model: the encoder takes precomputed frame embeddings (B, S_enc, d).
Encoder: bidirectional attention + sinusoidal positions.  Decoder: causal
self-attention + cross-attention to the encoder states + learned
positions; the logits come from the tied embedding.  The layers are
stacked ``(L, ...)`` under ``enc_layers`` and ``dec_layers``, the layout
the JAX model builds with ``vmap`` and scans over, so keys and shapes
match its pytree.

Every attention of the full-sequence paths goes through
``kernels.ops.flash_attention``: the encoder's non-causal over the frames,
the decoder's causal, and cross-attention non-causal from the decoder's
tokens to the encoder's frames.  The JAX model pads the self-attention's
heads to ``pad_heads_to`` for the mesh; on one device that changes
nothing, so the port runs the heads as they are.  Cross-attention runs
inside the profiler range ``CROSS_SPAN`` (``runtime/ranges.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (decode_attention, dense_init, init_device, layernorm,
                                       write_rows)
from repro_torch.models.lm import (check_ported, embed_tokens, init_stacked, next_token_ce,
                                   unstack)
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.ranges import span

CROSS_SPAN = "encdec.cross_attention"
ENC_LEN = 1500              # the encoder frames of a serving cache (30 s of audio)


def sinusoid_pos(S, d, device="cpu"):
    """(S, d) float32: the sines of the S positions at d // 2 frequencies,
    then their cosines (two blocks, not interleaved)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------- params

def _ln_init(cfg, device):
    return {"w": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device),
            "b": torch.zeros((cfg.d_model,), dtype=cfg.pdt, device=device)}


def _mlp_init(cfg, gen, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, (d, f), d, cfg.pdt, device),
            "b1": torch.zeros((f,), dtype=cfg.pdt, device=device),
            "w2": dense_init(gen, (f, d), f, cfg.pdt, device),
            "b2": torch.zeros((d,), dtype=cfg.pdt, device=device)}


def _enc_layer_init(cfg, gen, device):
    return {"ln1": _ln_init(cfg, device), "attn": attn.gqa_init(cfg, gen, device),
            "ln2": _ln_init(cfg, device), "mlp": _mlp_init(cfg, gen, device)}


def _dec_layer_init(cfg, gen, device):
    return {"ln1": _ln_init(cfg, device), "self": attn.gqa_init(cfg, gen, device),
            "ln2": _ln_init(cfg, device), "cross": attn.gqa_init(cfg, gen, device),
            "ln3": _ln_init(cfg, device), "mlp": _mlp_init(cfg, gen, device)}


def init_encdec(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random parameters drawn from ``gen`` on ``device`` (default
    ``gen.device``; on ``meta`` only their shapes and dtypes): the
    embedding, the decoder's position table (0.02·N(0, 1), as the JAX model
    draws it), the encoder's layers, then the decoder's, in that order."""
    check_ported(cfg)
    device = init_device(gen, device)
    params = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, cfg.pdt, device)}
    table = torch.randn((cfg.max_positions, cfg.d_model), generator=gen, device=device)
    params["dec_pos"] = (0.02 * table).to(cfg.pdt)
    params["enc_layers"] = init_stacked(cfg.enc_layers, lambda: _enc_layer_init(cfg, gen, device))
    params["dec_layers"] = init_stacked(cfg.dec_layers, lambda: _dec_layer_init(cfg, gen, device))
    params["enc_ln"], params["dec_ln"] = _ln_init(cfg, device), _ln_init(cfg, device)
    return params


# -------------------------------------------------------------------- block

def _mlp(pl, x):
    """The GELU MLP with biases.  ``jax.nn.gelu`` is the tanh approximation
    by default, so this is too."""
    h = F.gelu(x @ pl["w1"].to(x.dtype) + pl["b1"].to(x.dtype), approximate="tanh")
    return h @ pl["w2"].to(x.dtype) + pl["b2"].to(x.dtype)


def _ln(pl, x, eps):
    return layernorm(x, pl["w"], pl["b"], eps)


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder states (B, S_enc, d)
    in the compute dtype.  The frames and the sinusoid table are each cast
    to it before they are added, as in the JAX model."""
    B, S, d = frames.shape
    x = frames.to(cfg.cdt) + sinusoid_pos(S, d, frames.device)[None].to(cfg.cdt)
    for pl in unstack(params["enc_layers"], cfg.enc_layers):
        h = _ln(pl["ln1"], x, cfg.norm_eps)
        x = x + attn.gqa_forward(cfg, pl["attn"], h, None, causal=False)
        x = x + _mlp(pl["mlp"], _ln(pl["ln2"], x, cfg.norm_eps))
    return _ln(params["enc_ln"], x, cfg.norm_eps)


def _cross(cfg, pl_cross, h, attend):
    """Cross-attention's query projection, ``attend(q)`` -> (B, S, H, hd)
    and the output projection, under ``CROSS_SPAN``."""
    with span(CROSS_SPAN):
        q = pctx.split_last(h @ pl_cross["wq"].to(h.dtype), cfg.n_heads, cfg.head_dim)
        return pctx.merge_last(attend(q)) @ pl_cross["wo"].to(h.dtype)


def _dec_block(cfg, pl, x, enc_kv, *, return_kv=False):
    """Full-sequence decoder block.  ``enc_kv``: (k_e, v_e) precomputed.
    Returns (x, the self-attention's (k, v) with ``return_kv``, else None)."""
    h = _ln(pl["ln1"], x, cfg.norm_eps)
    a = attn.gqa_forward(cfg, pl["self"], h, None, causal=True, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    x = x + a
    x = x + _cross(cfg, pl["cross"], _ln(pl["ln2"], x, cfg.norm_eps),
                   lambda q: _cross_attention(cfg, q, *enc_kv))
    x = x + _mlp(pl["mlp"], _ln(pl["ln3"], x, cfg.norm_eps))
    return x, kv


def _cross_attention(cfg, q, k, v):
    """K1 non-causal from the decoder's queries to the encoder's keys.  On a
    mesh all three are pinned as self-attention pins them (JAX leaves them
    to its partitioner; the kernel's shards must meet, ``kernels/ops.py``)."""
    q, k, v = (pctx.constrain(t, ("__dp__", None, "model", None)) for t in (q, k, v))
    return ops.flash_attention(q, k, v, causal=False, scale=1.0 / (cfg.head_dim ** 0.5))


def cross_kv(cfg: ModelConfig, pl_cross, enc):
    """The cross-attention's keys and values over the encoder states, each
    (B, S_enc, KV, hd)."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = pctx.split_last(enc @ pl_cross["wk"].to(enc.dtype), KV, hd)
    v = pctx.split_last(enc @ pl_cross["wv"].to(enc.dtype), KV, hd)
    return k, v


def _embed(cfg, params, dec_tokens):
    """The decoder tokens' embeddings plus the first S rows of the position
    table, added in the compute dtype."""
    x = embed_tokens(params["embed"], dec_tokens).to(cfg.cdt)
    return x + params["dec_pos"][:dec_tokens.shape[1]][None].to(x.dtype)


def _logits(cfg, params, x):
    """The final LayerNorm, then the tied embedding: float32 logits."""
    x = _ln(params["dec_ln"], x, cfg.norm_eps)
    return (x @ params["embed"].T.to(x.dtype)).float()


def forward(cfg: ModelConfig, params, frames, dec_tokens):
    """Train path: (float32 logits over the decoder positions, aux = 0)."""
    check_ported(cfg)
    enc = encode(cfg, params, frames)
    x = _embed(cfg, params, dec_tokens)
    for pl in unstack(params["dec_layers"], cfg.dec_layers):
        x, _ = _dec_block(cfg, pl, x, cross_kv(cfg, pl["cross"], enc))
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, **_kw):
    """Next-token cross-entropy over the decoder tokens.  batch: {frames:
    (B, S_enc, d), dec_tokens: (B, S)}.  Returns (loss, {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch["frames"], batch["dec_tokens"])
    loss = next_token_ce(logits, batch["dec_tokens"])
    return loss, {"ce": loss, "aux": aux}


# ------------------------------------------------------------------ serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = ENC_LEN,
               device="cuda"):
    """Decode cache, stacked over the decoder's layers: the self-attention's
    k/v (``max_len`` rows) and the cross-attention's ek/ev over the
    ``enc_len`` encoder frames, in the compute dtype."""
    L, KV, hd = cfg.dec_layers, cfg.n_kv_heads, cfg.head_dim
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    for key, rows in (("k", max_len), ("v", max_len), ("ek", enc_len), ("ev", enc_len)):
        c[key] = torch.zeros((L, batch, rows, KV, hd), dtype=cfg.cdt, device=device)
    return c


def prefill(cfg: ModelConfig, params, frames, dec_tokens, max_len: int):
    """Encode, then run the decoder prompt; returns (last_logits, cache)."""
    check_ported(cfg)
    enc = encode(cfg, params, frames)
    B, Sd = dec_tokens.shape
    x = _embed(cfg, params, dec_tokens)
    cache = init_cache(cfg, B, max_len, enc.shape[1], dec_tokens.device)
    if isinstance(dec_tokens, DTensor):   # on a mesh: placed as serve_shardings places it
        mesh = dec_tokens.device_mesh
        cache = shd.distribute(cache, mesh, shd.cache_specs(cache, mesh), src_data_rank=None)
    cache["pos"].fill_(Sd)
    for i, pl in enumerate(unstack(params["dec_layers"], cfg.dec_layers)):
        ek, ev = cross_kv(cfg, pl["cross"], enc)
        x, (k, v) = _dec_block(cfg, pl, x, (ek, ev), return_kv=True)
        write_rows(cache["k"][i], 0, k)
        write_rows(cache["v"][i], 0, v)
        write_rows(cache["ek"][i], 0, ek)
        write_rows(cache["ev"][i], 0, ev)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decoder token against the self and cross caches.  tokens: (B, 1)
    int; returns (logits, cache), the cache's tensors updated in place.  The
    position table's row is read at ``cache["pos"]`` on the device, clamped
    to its last row as ``dynamic_slice`` clamps."""
    check_ported(cfg)
    pos = cache["pos"]
    x = embed_tokens(params["embed"], tokens).to(cfg.cdt)
    row = pos.clamp(0, cfg.max_positions - 1).reshape(1).long()
    x = x + params["dec_pos"].index_select(0, row)[None].to(x.dtype)
    last = cache["ek"].shape[2] - 1          # every encoder frame is visible
    for i, pl in enumerate(unstack(params["dec_layers"], cfg.dec_layers)):
        h = _ln(pl["ln1"], x, cfg.norm_eps)
        a, _, _ = attn.gqa_decode(cfg, pl["self"], h, cache["k"][i], cache["v"][i], pos)
        x = x + a
        ek, ev = cache["ek"][i], cache["ev"][i]
        x = x + _cross(cfg, pl["cross"], _ln(pl["ln2"], x, cfg.norm_eps),
                       lambda q: decode_attention(q, ek, ev, pos=last))
        x = x + _mlp(pl["mlp"], _ln(pl["ln3"], x, cfg.norm_eps))
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache
