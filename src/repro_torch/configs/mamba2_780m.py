"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 [arXiv:2405.21060].  SSD with expand 2 (d_inner 3072),
head_dim 64 (48 heads), conv 4, chunk 256."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-780m", family="ssm", attn_kind="none",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=1,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    ssm_pad_heads_to=16,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="mamba2-780m-smoke", family="ssm", attn_kind="none",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256, head_dim=1,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=16,
    tie_embeddings=True,
)
