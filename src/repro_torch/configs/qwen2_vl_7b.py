"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 [arXiv:2409.12191].  M-RoPE with (t,h,w) sections (16,24,24);
the vision tower is a STUB per the assignment — input_specs provides token
ids plus 3-axis position ids (patch embeddings would enter pre-projected)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    pos="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6, pad_heads_to=16,
)

SMOKE = ModelConfig(
    arch="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=32,
    pos="mrope", mrope_sections=(4, 6, 6), rope_theta=1e6, attn_block=32,
)
