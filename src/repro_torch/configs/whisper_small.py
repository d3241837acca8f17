"""whisper-small [audio, enc-dec] — 12L (enc) + 12L (dec) d_model=768 12H
d_ff=3072 vocab=51865 [arXiv:2212.04356].  The mel/conv frontend is a STUB:
input_specs provides precomputed frame embeddings (per the assignment)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-small", family="encdec",
    n_layers=24, enc_layers=12, dec_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64, pad_heads_to=16,
    pos="learned", max_positions=32768,       # decoder table covers decode_32k
)

SMOKE = ModelConfig(
    arch="whisper-small-smoke", family="encdec",
    n_layers=4, enc_layers=2, dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    pos="learned", max_positions=128, attn_block=32,
)
