"""Decoder-only LM assembly, dense (GQA or MLA attention) and ssm families:
a Python loop over the stacked ``(L, ...)`` layer parameters (the layout
``repro.models.lm`` builds with ``vmap`` and scans over, so keys and shapes
match its pytree), and four
entry points — ``forward`` (full sequence, with ``cfg.remat`` when autograd
records), ``loss_fn`` (next-token cross-entropy), ``prefill`` (build caches)
and ``decode_step`` (one token).  The other families come with their own
slices."""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, rope_cos_sin, swiglu

NEG_WINDOW_OFF = 1 << 30   # "window" value that disables windowing

_LATER = {
    "hybrid": "the hybrid (hymba) slice",
    "moe": "the MoE slice",
    "vlm": "the VLM slice",
    "encdec": "the enc-dec slice",
}


def check_ported(cfg: ModelConfig):
    """Raise NotImplementedError for what the port cannot run yet."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"{cfg.arch}: family {cfg.family!r} comes with "
                                  f"{_LATER.get(cfg.family, 'a later slice')}")
    if cfg.family == "ssm":
        if cfg.attn_kind != "none":
            raise NotImplementedError(f"{cfg.arch}: an ssm model with {cfg.attn_kind!r} "
                                      f"attention is the hybrid family's")
        return
    if cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.arch}: {cfg.attn_kind!r} attention is not "
                                  f"in the port")
    if cfg.pos != "rope":
        raise NotImplementedError(f"{cfg.arch}: {cfg.pos!r} positions come with "
                                  f"the slice that ports {cfg.arch}")


# ------------------------------------------------------------------- params

def _layer_init(cfg: ModelConfig, gen):
    norm1 = torch.ones((cfg.d_model,), dtype=cfg.pdt, device=gen.device)
    if cfg.family == "ssm":
        return {"norm1": norm1, "ssm": ssm_mod.ssm_init(cfg, gen)}
    return {"norm1": norm1,
            "attn": (attn.mla_init if cfg.attn_kind == "mla" else attn.gqa_init)(cfg, gen),
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


def _layers(tree, n: int):
    """The per-layer views of the stacked parameters, one dict per layer.
    One ``unbind`` per leaf: under autograd its backward stacks the layers'
    gradients once, where indexing would add a full-size gradient per
    layer."""
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


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
    """One block, full-sequence path.  Returns (x, kv): with ``return_kv``,
    the layer's cache entries in ``_cache_keys`` order: (k, v), MLA's
    (ckv, krope), or for ssm its (ssm state, conv state).  MLA takes no
    window."""
    if cfg.family == "ssm":
        out = ssm_mod.ssm_forward(cfg, pl["ssm"], rmsnorm(x, pl["norm1"], cfg.norm_eps),
                                  return_state=return_kv)
        if return_kv:
            out, state = out
            return x + out, state
        return x + out, None
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a = attn.mla_forward(cfg, pl["attn"], h, rope, return_kv=return_kv)
    else:
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
    """positions: (B,S) int32; returns (cos, sin), or None for ssm (no
    attention).  MLA's width is 2 * qk_rope_dim, as in the JAX version, of
    which its rope half reads the first qk_rope_dim / 2 frequencies."""
    if cfg.family == "ssm":
        return None
    dim = cfg.qk_rope_dim * 2 if cfg.attn_kind == "mla" else cfg.head_dim
    return rope_cos_sin(positions, dim, cfg.rope_theta)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _unembed(cfg, params, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ un.to(x.dtype)).float()


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    plain matrix products (the weight products), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``, as ``repro.models.lm._remat`` wraps the
    scanned layer: "none" saves every intermediate for the backward, "full"
    recomputes the whole layer in it, "dots" saves the weight products'
    outputs and recomputes the rest (attention included)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, dots or full, got {cfg.remat!r}")


def forward(cfg: ModelConfig, params, tokens, positions=None):
    """Full-sequence logits.  tokens: (B,S) int.  Returns (logits_f32, aux).
    When autograd records, each layer runs under ``cfg.remat``."""
    check_ported(cfg)
    if positions is None:
        positions = _positions(tokens)
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)

    def body(pl, x, win):
        return _block(cfg, pl, x, rope, win)[0]

    if torch.is_grad_enabled():
        body = _remat(cfg, body)
    for pl, win in zip(_layers(params["layers"], cfg.n_layers), layer_windows(cfg)):
        x = body(pl, x, int(win))
    return _unembed(cfg, params, x), torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight=0.01):
    """Next-token cross-entropy.  batch: {tokens: (B,S)}.  Returns
    (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, batch.get("positions"))
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# ------------------------------------------------------------------ serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache, stacked over layers: k/v (dense GQA), the latent ckv and
    krope (MLA), or ssm_state (float32) and conv_state (ssm; ``max_len``
    does not size it)."""
    L = cfg.n_layers
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        st, cv = ssm_mod.ssm_init_cache(cfg, batch, cfg.cdt, device)
        c["ssm_state"] = st.new_zeros((L, *st.shape))
        c["conv_state"] = cv.new_zeros((L, *cv.shape))
        return c
    if cfg.attn_kind == "mla":
        c["ckv"] = torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=cfg.cdt,
                               device=device)
        c["krope"] = torch.zeros((L, batch, max_len, cfg.qk_rope_dim), dtype=cfg.cdt,
                                 device=device)
        return c
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    c["k"] = torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device)
    c["v"] = torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device)
    return c


def _cache_keys(cfg: ModelConfig):
    """The per-layer cache entries ``_block_decode`` takes, in its order."""
    if cfg.family == "ssm":
        return ("ssm_state", "conv_state")
    return ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")


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
    for i, (pl, win) in enumerate(zip(_layers(params["layers"], cfg.n_layers),
                                      layer_windows(cfg))):
        x, kv = _block(cfg, pl, x, rope, int(win), return_kv=True)
        for key, val in zip(_cache_keys(cfg), kv):
            if cfg.family == "ssm":
                cache[key][i] = val
            else:
                cache[key][i, :, :S] = val
    return _unembed(cfg, params, x[:, -1:]), cache


def _block_decode(cfg: ModelConfig, pl, x, rope, window: int, caches, pos):
    """One block, one token.  ``caches``: this layer's cache views in
    ``_cache_keys`` order, updated in place.  Returns (x, caches)."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        out, st, cv = ssm_mod.ssm_decode(cfg, pl["ssm"], h, caches[0], caches[1])
        caches[0].copy_(st)
        caches[1].copy_(cv)
        return x + out, caches
    if cfg.attn_kind == "mla":
        a, *caches = attn.mla_decode(cfg, pl["attn"], h, caches[0], caches[1], pos, rope)
    else:
        a, *caches = attn.gqa_decode(cfg, pl["attn"], h, caches[0], caches[1], pos, rope,
                                     window=window)
    x = x + a
    h2 = rmsnorm(x, pl["norm2"], cfg.norm_eps)
    return x + _mlp(pl, h2), tuple(caches)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One serving step.  tokens: (B, 1) int; returns (logits, cache).  The
    cache's tensors are updated in place."""
    check_ported(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    positions = pos.to(torch.int32).broadcast_to((B, 1))
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)
    keys = _cache_keys(cfg)
    for i, (pl, win) in enumerate(zip(_layers(params["layers"], cfg.n_layers),
                                      layer_windows(cfg))):
        x, _ = _block_decode(cfg, pl, x, rope, int(win), tuple(cache[k][i] for k in keys), pos)
    cache["pos"] = pos + 1
    return _unembed(cfg, params, x), cache
