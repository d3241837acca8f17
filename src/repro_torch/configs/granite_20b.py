"""granite-20b [dense, code] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 [arXiv:2405.04324].  GPT-BigCode lineage: learned absolute
positions (table sized for the 32k decode cell)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    pos="learned", max_positions=32768, remat="full",
)

SMOKE = ModelConfig(
    arch="granite-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=16,
    pos="learned", max_positions=128, attn_block=32,
)
