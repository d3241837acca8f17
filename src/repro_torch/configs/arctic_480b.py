"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].

Memory posture (the largest assigned model, ~470 B params): bf16 params and
bf16 Adam moments so that train state fits the v5e fleet; see DESIGN.md."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, top_k=2, d_expert=4864, dense_residual=True, pad_heads_to=16,
    param_dtype="bfloat16", remat="full",
)

SMOKE = ModelConfig(
    arch="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, head_dim=16,
    n_experts=8, top_k=2, d_expert=96, dense_residual=True,
    moe_group=64, attn_block=32,
)
