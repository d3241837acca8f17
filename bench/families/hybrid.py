"""The ``hybrid`` family, Hymba (arXiv:2411.13676): attention heads (GQA,
NeoX rope, a causal window except on the global layers) and Mamba-2 heads
side by side on one normed input, summed with per-channel weights, then a
SwiGLU MLP.  Hymba's meta tokens and its cross-layer KV sharing are left
out, as the program leaves them out; its SSM heads are the ``ssm``
family's Mamba-2 mixer."""
from __future__ import annotations

import math

from bench.families import ssm
from bench.reference import model as ref
from bench.reference.weights import lm_specs
from bench.work.flops import attention_pair_flops, gqa_proj_flops, swiglu_flops, unembed_flops


def leaf_specs(m: dict) -> dict:
    d, L = m["d_model"], m["n_layers"]
    H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    res = 1.0 / math.sqrt(2 * L)          # two residual writes a layer
    lay = {"norm1": ((L, d), "ones", 0)}
    lay.update(ssm.mixer_specs(m, res))
    lay.update({
        "attn.wq": ((L, d, H * hd), "normal", d ** -0.5),
        "attn.wk": ((L, d, KV * hd), "normal", d ** -0.5),
        "attn.wv": ((L, d, KV * hd), "normal", d ** -0.5),
        "attn.wo": ((L, H * hd, d), "normal", (H * hd) ** -0.5 * res),
        "norm2": ((L, d), "ones", 0),
        "mlp.wg": ((L, d, f), "normal", d ** -0.5),
        "mlp.wu": ((L, d, f), "normal", d ** -0.5),
        "mlp.wd": ((L, f, d), "normal", f ** -0.5 * res),
        "fuse_a": ((L, d), "half", 0),
        "fuse_s": ((L, d), "half", 0),
    })
    return lm_specs(m, lay)


def block(m, pl, x, window, mm):
    eps = m["norm_eps"]
    h = ref.rmsnorm(x, pl["norm1"], eps)
    a = ref.attention(m, pl["attn"], h, window, mm)
    s = ref.ssm_mixer(m, pl["ssm"], h, mm)
    x = x + pl["fuse_a"] * a + pl["fuse_s"] * s
    return x + ref.swiglu(pl["mlp"], ref.rmsnorm(x, pl["norm2"], eps), mm)


def hidden(m, params, tokens, mm=ref.f32_mm, remat=False):
    return ref.decoder(m, params, tokens, block, mm, remat)


def forward_flops(m: dict, B: int, S: int, *, unembed_all: bool = True) -> int:
    L, tokens = m["n_layers"], B * S
    total = L * (ssm.mixer_flops(m, B, S) + gqa_proj_flops(m, tokens) + swiglu_flops(m, tokens))
    for i in range(L):
        win = 0 if i in m["global_layers"] else m["swa_window"]
        total += attention_pair_flops(m, B, S, win)
    return total + unembed_flops(m, B, S, unembed_all)


def ssd_scans(m: dict) -> list:
    return ssm.ssd_scans(m)
