"""minitron-8b [dense, pruned nemotron] — 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000 [arXiv:2407.14679].  head_dim 128 per nemotron."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, head_dim=128,
)

SMOKE = ModelConfig(
    arch="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=32, attn_block=32,
)
