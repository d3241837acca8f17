"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 [arXiv:2411.13676].  Parallel attention + mamba
heads per block; sliding-window attention except 3 global layers (first,
middle, last, per the paper).  Hymba's meta-tokens are omitted (orthogonal
to this framework's technique; noted in DESIGN.md)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    swa_window=1024, global_layers=(0, 15, 31), pad_heads_to=16,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    ssm_pad_heads_to=16,
)

SMOKE = ModelConfig(
    arch="hymba-1.5b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    swa_window=16, global_layers=(1,),
    ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=16,
    attn_block=32,
)
