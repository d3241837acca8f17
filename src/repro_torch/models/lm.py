"""Decoder-only LM assembly, dense (GQA or MLA attention), vlm (dense GQA
with M-RoPE's three position streams, as qwen2-vl), moe (a routed
mixture of experts in place of the MLP, plus a dense MLP beside it with
``dense_residual``, as arctic), ssm and hybrid (GQA attention and an SSM
side by side on the same normed input, as hymba) and pattern (one mixer a
block, Mamba-2, MoE or GQA attention as ``block_pattern`` says, as
NVIDIA's Nemotron-H) families, with rope, M-RoPE, learned absolute
positions (granite) or none: a
Python loop over the stacked ``(L, ...)`` layer
parameters (the layout ``repro.models.lm`` builds with ``vmap`` and scans
over, so keys and shapes match its pytree), and four entry points —
``forward`` (full sequence, with ``cfg.remat`` when autograd records;
it returns the MoE layers' summed load-balancing loss), ``loss_fn``
(next-token cross-entropy plus ``aux_weight`` times that loss),
``prefill`` (build caches) and ``decode_step`` (one token).  The
encoder-decoder family is ``models/encdec.py``'s; ``check_ported`` holds
the configs of both."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (dense_init, init_device, mrope_cos_sin, rmsnorm,
                                       rope_cos_sin, swiglu, write_rows)
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd

NEG_WINDOW_OFF = 1 << 30   # "window" value that disables windowing
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "pattern")
# a pattern block's kind by its letter in ``block_pattern``: the key of its
# stacked parameters (``params["layers"][kind]``), one tree a kind
PATTERN_KINDS = {"M": "mamba", "E": "moe", "*": "attention"}


def check_ported(cfg: ModelConfig):
    """Raise NotImplementedError for a family or attention the port does
    not know, and ValueError for position settings that do not fit the
    model: an unknown scheme, a learned table of no rows, or M-RoPE
    sections that do not sum to half the rotated width (the JAX model
    asserts that too)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.arch}: family {cfg.family!r} is not one of "
                                  f"{', '.join(FAMILIES)}")
    if cfg.family == "ssm":
        if cfg.attn_kind != "none":
            raise NotImplementedError(f"{cfg.arch}: an ssm model with {cfg.attn_kind!r} "
                                      f"attention is the hybrid family's")
    elif cfg.family == "pattern":
        _check_pattern(cfg)
    elif cfg.family == "hybrid" and cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.arch}: a hybrid model runs GQA attention beside "
                                  f"its SSM, got {cfg.attn_kind!r}")
    elif cfg.family == "encdec" and (cfg.attn_kind != "gqa" or cfg.pos != "learned"):
        raise NotImplementedError(f"{cfg.arch}: an encoder-decoder runs GQA attention with "
                                  f"learned decoder positions, got {cfg.attn_kind!r} and "
                                  f"{cfg.pos!r}")
    elif cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.arch}: {cfg.attn_kind!r} attention is not "
                                  f"in the port")
    if cfg.family == "moe" and (cfg.d_shared or cfg.n_router != cfg.n_experts):
        raise NotImplementedError(f"{cfg.arch}: the moe family routes over the experts it "
                                  f"holds, with no shared expert; a held share and a shared "
                                  f"expert are the pattern family's")
    if cfg.pos not in ("rope", "learned", "mrope", "none"):
        raise ValueError(f"{cfg.arch}: positions must be rope, learned or mrope (or none), "
                         f"got {cfg.pos!r}")
    if cfg.attn_kind == "mla" and cfg.pos != "rope":
        raise NotImplementedError(f"{cfg.arch}: MLA's decoupled half of q and k is "
                                  f"rotated by rope; {cfg.pos!r} positions leave it unrotated")
    if cfg.pos == "learned" and cfg.max_positions < 1:
        raise ValueError(f"{cfg.arch}: learned positions need a table, max_positions >= 1")
    if cfg.pos == "mrope" and sum(cfg.mrope_sections) != _rope_dim(cfg) // 2:
        raise ValueError(f"{cfg.arch}: M-RoPE sections {cfg.mrope_sections} must sum to "
                         f"half the rotated width, {_rope_dim(cfg) // 2}")


def _check_pattern(cfg: ModelConfig):
    """A pattern stack: one letter of ``PATTERN_KINDS`` a block, GQA
    attention, and MoE blocks on the dropless sigmoid-routed relu² path
    (``moe._moe_dropless``) over a held share of the router's experts."""
    if len(cfg.block_pattern) != cfg.n_layers or set(cfg.block_pattern) - set(PATTERN_KINDS):
        raise ValueError(f"{cfg.arch}: block_pattern {cfg.block_pattern!r} must hold one of "
                         f"{''.join(PATTERN_KINDS)} for each of the {cfg.n_layers} blocks")
    if cfg.blocks("*") and cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.arch}: a pattern's attention blocks run GQA, got "
                                  f"{cfg.attn_kind!r}")
    if cfg.blocks("E") and not 0 < cfg.n_experts <= cfg.n_router:
        raise ValueError(f"{cfg.arch}: a pattern's MoE blocks hold 1 to {cfg.n_router} of "
                         f"the router's experts, got {cfg.n_experts}")


# ------------------------------------------------------------------- params

def _layer_init(cfg: ModelConfig, gen, device):
    norm1 = torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device)
    if cfg.family == "ssm":
        return {"norm1": norm1, "ssm": ssm_mod.ssm_init(cfg, gen, device)}
    p = {"norm1": norm1,
         "attn": (attn.mla_init if cfg.attn_kind == "mla" else attn.gqa_init)(cfg, gen, device),
         "norm2": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(cfg, gen, device)
    if cfg.family != "moe" or cfg.dense_residual:
        p["mlp"] = _mlp_init(cfg, gen, device)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.ssm_init(cfg, gen, device)
        p["fuse_a"] = torch.full((cfg.d_model,), 0.5, dtype=cfg.pdt, device=device)
        p["fuse_s"] = torch.full((cfg.d_model,), 0.5, dtype=cfg.pdt, device=device)
    return p


def _pattern_init(cfg: ModelConfig, kind: str, gen, device):
    """One pattern block of ``kind``: its norm and its mixer."""
    p = {"norm1": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device)}
    if kind == "mamba":
        p["ssm"] = ssm_mod.ssm_init(cfg, gen, device)
    elif kind == "moe":
        p["moe"] = moe_mod.moe_init(cfg, gen, device)
    else:
        p["attn"] = attn.gqa_init(cfg, gen, device)
    return p


def _mlp_init(cfg, gen, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": dense_init(gen, (d, f), d, cfg.pdt, device),
            "wu": dense_init(gen, (d, f), d, cfg.pdt, device),
            "wd": dense_init(gen, (f, d), f, cfg.pdt, device)}


def init_stacked(n: int, draw):
    """``n`` layers' parameters stacked ``(n, ...)``: layer 0's draws
    (``draw()``, one layer's dict), then layer 1's, ..., each written into
    the stacked tensors as it is drawn, so one layer's copy is alive at a
    time beside the stack."""
    def empty_stacked(tree):
        return {k: empty_stacked(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in tree.items()}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    stacked = None
    for i in range(n):
        layer = draw()
        if stacked is None:
            stacked = empty_stacked(layer)
        fill(stacked, layer, i)
    return stacked


def unstack(tree, n: int):
    """The per-layer views of the stacked parameters, one dict per layer.
    One ``unbind`` per leaf: under autograd its backward stacks the layers'
    gradients once, where indexing would add a full-size gradient per
    layer."""
    per_leaf = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def init_lm(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random parameters drawn from ``gen`` on ``device`` (default
    ``gen.device``; on ``meta`` only their shapes and dtypes): the
    embedding, the layers, the unembedding (untied) and the learned
    position table (0.02·N(0, 1), as the JAX model draws it), in that
    order."""
    check_ported(cfg)
    device = init_device(gen, device)
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, cfg.pdt, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=device),
    }
    if cfg.family == "pattern":     # one stack a kind of block, in PATTERN_KINDS' order
        params["layers"] = {kind: init_stacked(cfg.blocks(ch), lambda kind=kind: _pattern_init(
            cfg, kind, gen, device)) for ch, kind in PATTERN_KINDS.items() if cfg.blocks(ch)}
    else:
        params["layers"] = init_stacked(cfg.n_layers, lambda: _layer_init(cfg, gen, device))
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, cfg.pdt, device)
    if cfg.pos == "learned":
        table = torch.randn((cfg.max_positions, cfg.d_model), generator=gen, device=device)
        params["pos_table"] = (0.02 * table).to(cfg.pdt)
    return params


def layer_windows(cfg: ModelConfig) -> torch.Tensor:
    """Per-layer attention window (NEG_WINDOW_OFF = full attention): a
    hybrid model's ``global_layers`` attend in full, its others over
    ``swa_window``.  Kept on the CPU: the loop reads each entry with
    ``int()``."""
    w = cfg.swa_window if cfg.swa_window else NEG_WINDOW_OFF
    win = torch.full((cfg.n_layers,), w, dtype=torch.int32)
    if cfg.family == "hybrid" and cfg.swa_window and cfg.global_layers:
        win[list(cfg.global_layers)] = NEG_WINDOW_OFF
    return win


# -------------------------------------------------------------------- block

def _mlp(pl, x):
    return swiglu(x, pl["mlp"]["wg"].to(x.dtype), pl["mlp"]["wu"].to(x.dtype),
                  pl["mlp"]["wd"].to(x.dtype))


def _fuse(pl, x, a, s_out):
    """The hybrid sum: the residual plus the attention and SSM outputs,
    each weighted per channel."""
    return x + pl["fuse_a"].to(x.dtype) * a + pl["fuse_s"].to(x.dtype) * s_out


def _ffn(cfg: ModelConfig, pl, h2):
    """The block's second half on the normed ``h2``: (out, aux).  moe: the
    routed experts, plus the dense MLP with ``dense_residual``, and the
    layer's load-balancing loss; otherwise the MLP and aux None."""
    if cfg.family != "moe":
        return _mlp(pl, h2), None
    m, aux = moe_mod.moe_forward(cfg, pl["moe"], h2)
    # on a mesh, back to h2's shards from the expert-parallel path's (the
    # sequence over ``model``): torch 2.11's DTensor cannot flatten (B, S)
    # for the next layer's products with S sharded
    m = pctx.placed_like(m, h2)
    return (m + _mlp(pl, h2) if cfg.dense_residual else m), aux


def _block(cfg: ModelConfig, pl, x, rope, window: int, *, return_kv=False):
    """One block, full-sequence path.  Returns (x, aux, kv): aux the MoE
    layer's load-balancing loss (None for the other families); with
    ``return_kv`` kv is the layer's cache entries in ``_cache_keys`` order:
    (k, v), MLA's (ckv, krope), for ssm its (ssm state, conv state), for
    hybrid (k, v, ssm state, conv state).  MLA takes no window."""
    if cfg.family == "ssm":
        out = ssm_mod.ssm_forward(cfg, pl["ssm"], rmsnorm(x, pl["norm1"], cfg.norm_eps),
                                  return_state=return_kv)
        if return_kv:
            out, state = out
            return x + out, None, state
        return x + out, None, None
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a = attn.mla_forward(cfg, pl["attn"], h, rope, return_kv=return_kv)
    else:
        a = attn.gqa_forward(cfg, pl["attn"], h, rope, window=window, return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    if cfg.family == "hybrid":
        s_out = ssm_mod.ssm_forward(cfg, pl["ssm"], h, return_state=return_kv)
        if return_kv:
            s_out, state = s_out
            kv = (*kv, *state)
        x = _fuse(pl, x, a, s_out)
    else:
        x = x + a
    out, aux = _ffn(cfg, pl, rmsnorm(x, pl["norm2"], cfg.norm_eps))
    return x + out, aux, kv


def _pattern_blocks(cfg: ModelConfig, layers):
    """(kind, its parameters, its index among its kind) of each block of
    ``block_pattern`` in order, from the stacked trees ``layers``."""
    per = {kind: unstack(layers[kind], cfg.blocks(ch)) for ch, kind in PATTERN_KINDS.items()
           if cfg.blocks(ch)}
    seen = dict.fromkeys(per, 0)
    for ch in cfg.block_pattern:
        kind = PATTERN_KINDS[ch]
        yield kind, per[kind][seen[kind]], seen[kind]
        seen[kind] += 1


def _pattern_block(cfg: ModelConfig, kind: str, pl, x, *, return_kv=False):
    """One pattern block, x + mixer(rmsnorm(x)), full-sequence path.  Returns
    (x, kv): with ``return_kv`` its cache entries (Mamba's (ssm state, conv
    state), attention's (k, v)), else None; an MoE block has none."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    kv = None
    if kind == "moe":
        out, _ = moe_mod.moe_forward(cfg, pl["moe"], h)
    elif kind == "mamba":
        out = ssm_mod.ssm_forward(cfg, pl["ssm"], h, return_state=return_kv)
    else:
        out = attn.gqa_forward(cfg, pl["attn"], h, None, return_kv=return_kv)
    if return_kv and kind != "moe":
        out, kv = out
    return x + out, kv


def _pattern_block_decode(cfg: ModelConfig, kind: str, pl, x, caches, pos):
    """One pattern block, one token; ``caches`` its kind's cache views at
    its index (Mamba's ssm and conv state, attention's k and v), updated in
    place."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    if kind == "moe":
        return x + moe_mod.moe_forward(cfg, pl["moe"], h)[0]
    if kind == "mamba":
        return x + _ssm_decode(cfg, pl, h, *caches)
    return x + attn.gqa_decode(cfg, pl["attn"], h, *caches, pos)[0]


# ----------------------------------------------------------------- forward

def _embed(cfg, params, tokens):
    """The tokens' embeddings in the compute dtype, plus the first S rows of
    the learned position table when the model has one: those rows whatever
    ``positions`` says, as in the JAX model."""
    x = embed_tokens(params["embed"], tokens).to(cfg.cdt)
    if cfg.pos == "learned":
        x = x + params["pos_table"][:tokens.shape[1]][None].to(x.dtype)
    return x


def embed_tokens(table, tokens):
    """The rows of the embedding ``table`` (V, d) at ``tokens``.  On a mesh
    the table is first gathered whole on every rank: DTensor's lookup into
    rows sharded over the vocab fails (its masked partial sums, torch 2.11
    and 2.13), where JAX's partitioner looks up in the shards.  Through
    ``F.embedding``, whose backward DTensor partitions (the rule for
    indexing's ``index_put`` fails in torch 2.11)."""
    return F.embedding(tokens.long(), pctx.constrain(table, (None, None)))


def _rope_dim(cfg: ModelConfig) -> int:
    """The rotated width: MLA's is 2 * qk_rope_dim, as in the JAX version,
    of which its rope half reads the first qk_rope_dim / 2 frequencies."""
    return cfg.qk_rope_dim * 2 if cfg.attn_kind == "mla" else cfg.head_dim


def _rope_for(cfg: ModelConfig, positions):
    """positions: (B,S) int32, or (3,B,S) for mrope; returns (cos, sin), or
    None for ssm (no attention), for learned positions (added to the
    embedding instead) and for none."""
    if cfg.family == "ssm" or cfg.pos in ("learned", "none"):
        return None
    if cfg.pos == "mrope":
        return mrope_cos_sin(positions, _rope_dim(cfg), cfg.rope_theta, cfg.mrope_sections)
    return rope_cos_sin(positions, _rope_dim(cfg), cfg.rope_theta)


def _positions(cfg: ModelConfig, tokens):
    """Each row's 0..S-1: (B, S), or (3, B, S) for mrope (t = h = w, text)."""
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    return pos.expand(3, B, S) if cfg.pos == "mrope" else pos


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
    """Full-sequence logits.  tokens: (B,S) int; positions (B,S), or
    (3,B,S) for mrope, default 0..S-1.  Returns (logits_f32, aux): aux the
    float32 sum of the MoE layers' load-balancing losses (0 for the other
    families).  When autograd records, each layer runs under ``cfg.remat``."""
    check_ported(cfg)
    if positions is None:
        positions = _positions(cfg, tokens)
    x = _embed(cfg, params, tokens)
    if cfg.family == "pattern":
        for kind, pl, _ in _pattern_blocks(cfg, params["layers"]):
            x = _pattern_block(cfg, kind, pl, x)[0]
        return _unembed(cfg, params, x), torch.zeros((), device=x.device)
    rope = _rope_for(cfg, positions)

    def body(pl, x, win):
        return _block(cfg, pl, x, rope, win)[:2]

    if torch.is_grad_enabled():
        body = _remat(cfg, body)
    aux = torch.zeros((), device=x.device)
    for pl, win in zip(unstack(params["layers"], cfg.n_layers), layer_windows(cfg)):
        x, layer_aux = body(pl, x, int(win))
        if layer_aux is not None:
            aux = aux + layer_aux
    return _unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight=0.01):
    """Next-token cross-entropy.  batch: {tokens: (B,S)}.  Returns
    (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, batch.get("positions"))
    loss = next_token_ce(logits, tokens)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def next_token_ce(logits, tokens):
    """The mean cross-entropy of each position's logits (B, S, V) against
    the next token of ``tokens`` (B, S).  On a mesh the vocab dim is first
    gathered whole on every rank: DTensor cannot take a target's logit out
    of vocab-sharded logits (its gather fails), where JAX's partitioner
    gathers from the shards."""
    lg = pctx.constrain(logits[:, :-1], ("__dp__", None, None))
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return torch.mean(lse - ll)


# ------------------------------------------------------------------ serving

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Decode cache, stacked over layers: k/v (dense GQA), the latent ckv and
    krope (MLA), ssm_state (float32) and conv_state (ssm; ``max_len`` does
    not size them), or k/v and both SSM entries (hybrid); a pattern's k/v
    stacked over its attention blocks, its SSM entries over its Mamba
    blocks."""
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "pattern":     # k/v at the attention blocks, SSM state at the Mamba ones
        n_attn, n_ssm = cfg.blocks("*"), cfg.blocks("M")
    else:
        n_attn = n_ssm = cfg.n_layers
    L = n_attn
    if cfg.family != "ssm" and n_attn:
        if cfg.attn_kind == "mla":
            c["ckv"] = torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=cfg.cdt,
                                   device=device)
            c["krope"] = torch.zeros((L, batch, max_len, cfg.qk_rope_dim), dtype=cfg.cdt,
                                     device=device)
        else:
            kvh, hd = cfg.n_kv_heads, cfg.head_dim
            c["k"] = torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device)
            c["v"] = torch.zeros((L, batch, max_len, kvh, hd), dtype=cfg.cdt, device=device)
    if cfg.family in ("ssm", "hybrid") or (cfg.family == "pattern" and n_ssm):
        st, cv = ssm_mod.ssm_init_cache(cfg, batch, cfg.cdt, device)
        c["ssm_state"] = st.new_zeros((n_ssm, *st.shape))
        c["conv_state"] = cv.new_zeros((n_ssm, *cv.shape))
    return c


SSM_KEYS = ("ssm_state", "conv_state")   # whole per layer: no sequence axis


def _cache_keys(cfg: ModelConfig, kind: str = ""):
    """The per-layer cache entries ``_block_decode`` takes, in its order; a
    pattern block's by its ``kind`` (none for MoE)."""
    if cfg.family == "pattern":
        return {"mamba": SSM_KEYS, "attention": ("k", "v")}.get(kind, ())
    if cfg.family == "ssm":
        return SSM_KEYS
    keys = ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")
    return (*keys, *SSM_KEYS) if cfg.family == "hybrid" else keys


def prefill(cfg: ModelConfig, params, tokens, max_len: int, positions=None):
    """Run the full prompt, return (last_logits, cache)."""
    check_ported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = _positions(cfg, tokens)
    x = _embed(cfg, params, tokens)
    rope = _rope_for(cfg, positions)
    cache = init_cache(cfg, B, max_len, tokens.device)
    if isinstance(tokens, DTensor):   # on a mesh: placed as serve_shardings places it
        mesh = tokens.device_mesh
        cache = shd.distribute(cache, mesh, shd.cache_specs(cache, mesh), src_data_rank=None)
    cache["pos"].fill_(S)
    if cfg.family == "pattern":
        for kind, pl, i in _pattern_blocks(cfg, params["layers"]):
            x, kv = _pattern_block(cfg, kind, pl, x, return_kv=True)
            for key, val in zip(_cache_keys(cfg, kind), kv or ()):
                _write_cache(cache, key, i, val)
        return _unembed(cfg, params, x[:, -1:]), cache
    for i, (pl, win) in enumerate(zip(unstack(params["layers"], cfg.n_layers),
                                      layer_windows(cfg))):
        x, _, kv = _block(cfg, pl, x, rope, int(win), return_kv=True)
        for key, val in zip(_cache_keys(cfg), kv):
            _write_cache(cache, key, i, val)
    return _unembed(cfg, params, x[:, -1:]), cache


def _write_cache(cache, key: str, i: int, val):
    """A prefill's entry into layer ``i`` of ``cache[key]``: an SSM entry
    whole, k/v-like entries into the first rows."""
    if key in SSM_KEYS:
        cache[key][i] = val
    else:
        write_rows(cache[key][i], 0, val)


def _ssm_decode(cfg: ModelConfig, pl, h, state, conv_state):
    """The SSM's one-token step, its two cache views updated in place."""
    out, st, cv = ssm_mod.ssm_decode(cfg, pl["ssm"], h, state, conv_state)
    state.copy_(st)
    conv_state.copy_(cv)
    return out


def _block_decode(cfg: ModelConfig, pl, x, rope, window: int, caches, pos):
    """One block, one token.  ``caches``: this layer's cache views in
    ``_cache_keys`` order, updated in place.  Returns (x, caches)."""
    h = rmsnorm(x, pl["norm1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + _ssm_decode(cfg, pl, h, *caches), caches
    if cfg.attn_kind == "mla":
        a, *new = attn.mla_decode(cfg, pl["attn"], h, caches[0], caches[1], pos, rope)
    else:
        a, *new = attn.gqa_decode(cfg, pl["attn"], h, caches[0], caches[1], pos, rope,
                                  window=window)
    if cfg.family == "hybrid":
        x = _fuse(pl, x, a, _ssm_decode(cfg, pl, h, *caches[2:]))
        new += caches[2:]
    else:
        x = x + a
    out, _ = _ffn(cfg, pl, rmsnorm(x, pl["norm2"], cfg.norm_eps))
    return x + out, tuple(new)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One serving step.  tokens: (B, 1) int; returns (logits, cache).  The
    cache's tensors are updated in place.  The token's position is
    ``cache["pos"]``: in all three M-RoPE streams, and the learned table's
    row there, clamped to its last row as ``dynamic_slice`` clamps (read on
    the device, with no sync to the host)."""
    check_ported(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    positions = pos.to(torch.int32).broadcast_to((3, B, 1) if cfg.pos == "mrope" else (B, 1))
    x = embed_tokens(params["embed"], tokens).to(cfg.cdt)
    if cfg.pos == "learned":
        row = pos.clamp(0, cfg.max_positions - 1).reshape(1).long()
        x = x + params["pos_table"].index_select(0, row)[None].to(x.dtype)
    if cfg.family == "pattern":
        for kind, pl, i in _pattern_blocks(cfg, params["layers"]):
            x = _pattern_block_decode(cfg, kind, pl, x,
                                      tuple(cache[k][i] for k in _cache_keys(cfg, kind)), pos)
        cache["pos"] = pos + 1
        return _unembed(cfg, params, x), cache
    rope = _rope_for(cfg, positions)
    keys = _cache_keys(cfg)
    for i, (pl, win) in enumerate(zip(unstack(params["layers"], cfg.n_layers),
                                      layer_windows(cfg))):
        x, _ = _block_decode(cfg, pl, x, rope, int(win), tuple(cache[k][i] for k in keys), pos)
    cache["pos"] = pos + 1
    return _unembed(cfg, params, x), cache
