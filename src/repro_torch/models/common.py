"""Model configuration shared by every architecture the port serves: the
ten of the JAX package's registry and the port's own (``configs/registry.py``
``PORT_ARCHS``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | pattern
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # -- attention ---------------------------------------------------------
    attn_kind: str = "gqa"           # gqa | mla | none
    pos: str = "rope"                # rope | learned | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    swa_window: int = 0              # 0 = full attention
    global_layers: Tuple[int, ...] = ()   # hybrid: layers with full attention
    attn_block: int = 1024           # kv-block for blocked (flash-style) attn
    # --- TP-friendliness (see EXPERIMENTS.md §Perf) ---------------------
    # repeat KV heads to full H in the train/prefill path so the attention
    # einsums shard over the model axis even when n_kv_heads < TP degree
    # (otherwise XLA replicates ALL attention compute/memory per shard).
    tp_repeat_kv: bool = True
    # pad the (repeated) head dim to a multiple of this so odd head counts
    # (25/28/40/56) shard over a 16-way model axis; 0 = off.
    pad_heads_to: int = 0

    # -- MLA (MiniCPM3 / DeepSeek style) ------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # expert hidden (d_ff used for dense MLP)
    dense_residual: bool = False     # Arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    moe_group: int = 2048            # tokens per dispatch group
    router_experts: int = 0          # the router's outputs; 0 -> n_experts.  Experts
    #                                  0..n_experts-1 of them are held here
    routed_scale: float = 1.0        # the routed experts' weights scaled by this
    d_shared: int = 0                # a shared expert of this width beside them; 0: none

    # -- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_pad_heads_to: int = 0        # pad SSD heads so they shard over TP
    ssm_n_heads: int = 0             # SSD heads; 0 -> ssm_expand * d_model / ssm_head_dim
    ssm_groups: int = 1              # B/C groups; the gated norm runs over each group

    # -- pattern: one mixer a block, x + mixer(rmsnorm(x)) ----------------------
    block_pattern: str = ""          # M Mamba-2, E MoE, * attention, one char a block

    # -- encoder-decoder -------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    max_positions: int = 0           # learned-position table size (0: unused)

    # -- numerics / misc --------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def d_inner(self) -> int:        # SSM inner width
        if self.ssm_n_heads:
            return self.ssm_n_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_router(self) -> int:       # the router's outputs
        return self.router_experts or self.n_experts

    def blocks(self, kind: str) -> int:
        """How many blocks of ``block_pattern`` are of ``kind`` (M, E or *)."""
        return self.block_pattern.count(kind)

    def _ssm_params(self) -> int:
        d, di, n, h = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        gn = self.ssm_groups * n
        return d * (2 * di + 2 * gn + h) + (di + 2 * gn) * (self.ssm_conv + 1) + 3 * h \
            + di + di * d

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "pattern":
            return emb + d + self._pattern_params(self.n_experts)
        if self.family == "ssm":
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * n + h) + di * (self.ssm_conv + 1) + 2 * h + di * d + d
            return emb + self.n_layers * per + d
        att = self._attn_params()
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        per = att + mlp + 2 * d
        if self.family == "moe":
            per = att + 2 * d + d * self.n_experts + self.n_experts * 3 * d * self.d_expert
            if self.dense_residual:
                per += 3 * d * self.d_ff
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * n + self.ssm_heads) + di * (self.ssm_conv + 1) \
                + 2 * self.ssm_heads + di * d
            per = att + mlp + ssm + 3 * d
        layers = self.n_layers
        if self.family == "encdec":
            layers = self.enc_layers + self.dec_layers
            per += att + d          # cross-attention + extra norm (decoder avg.)
        return emb + layers * per + d

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attn_kind == "mla":
            q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_dim) \
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            o = self.n_heads * self.v_head_dim * d
            return q + kv + o
        if self.attn_kind == "none":
            return 0
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _pattern_params(self, experts: int) -> int:
        """A pattern stack's blocks (each with its norm), with ``experts``
        routed experts in each MoE block: a router with its correction bias,
        relu² experts (an up and a down projection) and the shared one."""
        d = self.d_model
        moe = (d + 1) * self.n_router + experts * 2 * d * self.d_expert + 2 * d * self.d_shared
        return (self.blocks("M") * (self._ssm_params() + d) + self.blocks("E") * (moe + d)
                + self.blocks("*") * (self._attn_params() + d))

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only) for 6·N_active·D."""
        if self.family == "pattern":
            emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
            return emb + self.d_model + self._pattern_params(self.top_k)
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        att = self._attn_params()
        per = att + 2 * d + d * self.n_experts + self.top_k * 3 * d * self.d_expert
        if self.dense_residual:
            per += 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * per + d
