"""minicpm3-4b [dense, MLA] — 62L d_model=2560 40H d_ff=6400 vocab=73448
[hf:openbmb/MiniCPM3-4B].  MLA dims per the HF config: q_lora 768,
kv_lora 256, qk_nope 64, qk_rope 32, v_head 64."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="minicpm3-4b", family="dense", attn_kind="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=96,          # qk_nope + qk_rope
    q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32, qk_nope_dim=64,
    v_head_dim=64, tie_embeddings=True, pad_heads_to=16,
)

SMOKE = ModelConfig(
    arch="minicpm3-4b-smoke", family="dense", attn_kind="mla",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=24,
    q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
    v_head_dim=16, tie_embeddings=True, attn_block=32,
)
