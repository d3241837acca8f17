"""Decoder-only LM assembly, dense family: a Python loop over the stacked
``(L, ...)`` layer parameters (the layout ``repro.models.lm`` builds with
``vmap`` and scans over, so keys and shapes match its pytree), and three
entry points — ``forward`` (full sequence), ``prefill`` (build caches) and
``decode_step`` (one token).  Training (``loss_fn``, remat) comes with the
training slice; the other families with their own slices."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, rope_cos_sin, swiglu

NEG_WINDOW_OFF = 1 << 30   # "window" value that disables windowing

_LATER = {
    "ssm": "the mamba2 serving slice",
    "hybrid": "the hybrid (hymba) slice",
    "moe": "the MoE slice",
    "vlm": "the VLM slice",
    "encdec": "the enc-dec slice",
}


def check_ported(cfg: ModelConfig):
    """Raise NotImplementedError for what the port cannot run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.arch}: family {cfg.family!r} comes with "
                                  f"{_LATER.get(cfg.family, 'a later slice')}")
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.arch}: {cfg.attn_kind!r} attention comes "
                                  f"with the MLA slice")
    if cfg.pos != "rope":
        raise NotImplementedError(f"{cfg.arch}: {cfg.pos!r} positions come with "
                                  f"the slice that ports {cfg.arch}")


# ------------------------------------------------------------------- params

def _layer_init(cfg: ModelConfig, gen):
    return {"norm1": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=gen.device),
            "attn": attn.gqa_init(cfg, gen),
            "norm2": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=gen.device),
            "mlp": _mlp_init(cfg, gen)}


def _mlp_init(cfg, gen):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_init(gen, (d, f), d, cfg.pdt),
            "wu": dense_init(gen, (d, f), d, cfg.pdt),
            "wd": dense_init(gen, (f, d), f, cfg.pdt)}


def _init_layers(cfg: ModelConfig, gen):
    """Layer 0's draws, then layer 1's, ..., each written into the stacked
    ``(L, ...)`` tensors as it is drawn, so one layer's copy is alive at a
    time beside the stack."""
    def empty_stacked(tree):
        return {k: empty_stacked(v) if isinstance(v, dict)
                else v.new_empty((cfg.n_layers, *v.shape)) for k, v in tree.items()}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    stacked = None
    for i in range(cfg.n_layers):
        layer = _layer_init(cfg, gen)
        if stacked is None:
            stacked = empty_stacked(layer)
        fill(stacked, layer, i)
    return stacked


def _layer(tree, i: int):
    """The i-th layer's slice of the stacked parameters (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def init_lm(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    check_ported(cfg)
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, cfg.pdt),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=gen.device),
        "layers": _init_layers(cfg, gen),
    } | ({} if cfg.tie_embeddings else {
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, cfg.pdt)})


def layer_windows(cfg: ModelConfig) -> torch.Tensor:
    """Per-layer attention window (NEG_WINDOW_OFF = full attention).  Kept
    on the CPU: the loop reads each entry with ``int()``."""
    w = cfg.swa_window if cfg.swa_window else NEG_WINDOW_OFF
    return torch.full((cfg.n_layers,), w, dtype=torch.int32)


# -------------------------------------------------------------------- block

def _mlp(pl, x):
    return swiglu(x, pl["mlp"]["wg"].to(x.dtype), pl["mlp"]["wu"].to(x.dtype),
                  pl["mlp"]["wd"].to(x.dtype))


def _block(cfg: ModelConfig, pl, x, rope, window: int, *, return_kv=False):
    """One transformer block, full-sequence path.  Returns (x, kv)."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    a = attn.gqa_forward(cfg, pl["attn"], h, rope, window=window, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    x = x + a
    h2 = rmsnorm(x, pl["norm2"], cfg.norm_eps)
    return x + _mlp(pl, h2), kv


# ----------------------------------------------------------------- forward

def _embed(cfg, params, tokens):
    return params["embed"][tokens.long()].to(cfg.cdt)


def _rope_for(cfg: ModelConfig, positions):
    """positions: (B,S) int32; returns (cos, sin)."""
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _unembed(cfg, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ un.to(x.dtype)).float()


def forward(cfg: ModelConfig, params, tokens, positions=None):
    """Full-sequence logits.  tokens: (B,S) int.  Returns (logits_f32, aux)."""
    check_ported(cfg)
    if positions is None:
        positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)
    for i, win in enumerate(layer_windows(cfg)):
        x, _ = _block(cfg, _layer(params["layers"], i), x, rope, int(win))
    return _unembed(cfg, params, x), torch.zeros((), device=x.device)


# ------------------------------------------------------------------ serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache, stacked over layers."""
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device),
            "v": torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device)}


def prefill(cfg: ModelConfig, params, tokens, max_len: int, positions=None):
    """Run the full prompt, return (last_logits, cache)."""
    check_ported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)
    cache = init_cache(cfg, B, max_len, tokens.device)
    cache["pos"].fill_(S)
    for i, win in enumerate(layer_windows(cfg)):
        x, (k, v) = _block(cfg, _layer(params["layers"], i), x, rope, int(win),
                           return_kv=True)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _unembed(cfg, params, x[:, -1:]), cache


def _block_decode(cfg: ModelConfig, pl, x, rope, window: int, caches, pos):
    """One block, one token.  ``caches``: this layer's (k, v) cache views,
    updated in place.  Returns (x, caches)."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    a, kc, vc = attn.gqa_decode(cfg, pl["attn"], h, caches[0], caches[1], pos, rope,
                                window=window)
    x = x + a
    h2 = rmsnorm(x, pl["norm2"], cfg.norm_eps)
    return x + _mlp(pl, h2), (kc, vc)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One serving step.  tokens: (B, 1) int; returns (logits, cache).  The
    cache's k/v tensors are updated in place."""
    check_ported(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    positions = pos.to(torch.int32).broadcast_to((B, 1))
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)
    for i, win in enumerate(layer_windows(cfg)):
        x, _ = _block_decode(cfg, _layer(params["layers"], i), x, rope, int(win),
                             (cache["k"][i], cache["v"][i]), pos)
    cache["pos"] = pos + 1
    return _unembed(cfg, params, x), cache
