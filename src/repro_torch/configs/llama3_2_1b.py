"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=64,
    rope_theta=500000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    rope_theta=500000.0, tie_embeddings=True, attn_block=32,
)
