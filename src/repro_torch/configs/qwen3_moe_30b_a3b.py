"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768, vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
Qwen3 decouples head_dim (128) from d_model/n_heads."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, d_expert=768,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    arch="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=0, vocab=256, head_dim=32,
    n_experts=8, top_k=2, d_expert=48,
    rope_theta=1e6, moe_group=64, attn_block=32,
)
