"""nemotron-3-nano-30b-a3b [pattern] — 52 blocks d_model=2688 by
``hybrid_override_pattern`` (23 Mamba-2, 23 MoE, 6 GQA attention), vocab
131072, untied [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16].  Each block
is x + mixer(rmsnorm(x)).  Mamba-2: 64 heads of 64 (4096 wide, not expand ·
d), 8 groups, state 128, chunk 128, conv 4 with a bias, the gated norm over
each group's 512 channels.  MoE: a float32 sigmoid router over 128 experts
with a score correction bias, top 6 weighted by their normalised scores
times 2.5, relu² experts of 1856 and one shared relu² expert of 3712,
nothing dropped.  Attention: 32 query heads on 2 kv heads of 128, no rope
(the published modeling code applies none).  bfloat16 parameters, as the
checkpoint: 31.6 B, 63.2 GB.

The whole model does not fit one 80 GB card beside its prefill
transients; ``launch.profile_serve.one_card_config`` holds card 0's share
of two-way expert parallelism (experts 0-63 of each MoE block, every other
weight whole: 16.9 B parameters, 33.8 GB)."""
from repro_torch.models.common import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    arch="nemotron-3-nano-30b-a3b", family="pattern", attn_kind="gqa", pos="none",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2,
    d_ff=0, vocab=131072, head_dim=128, block_pattern=PATTERN,
    n_experts=128, router_experts=128, top_k=6, d_expert=1856, d_shared=3712,
    routed_scale=2.5,
    ssm_state=128, ssm_n_heads=64, ssm_head_dim=64, ssm_groups=8, ssm_conv=4, ssm_chunk=128,
    param_dtype="bfloat16",
)

# every block kind, g > 1 and a held share: 8 of 16 experts, top 3
SMOKE = ModelConfig(
    arch="nemotron-3-nano-smoke", family="pattern", attn_kind="gqa", pos="none",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=0, vocab=256, head_dim=16, block_pattern="MEM*EME",
    n_experts=8, router_experts=16, top_k=3, d_expert=48, d_shared=96,
    routed_scale=2.5,
    ssm_state=16, ssm_n_heads=8, ssm_head_dim=16, ssm_groups=2, ssm_conv=4, ssm_chunk=16,
    attn_block=32, param_dtype="bfloat16",
)
