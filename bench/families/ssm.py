"""The ``ssm`` family, Mamba-2 (arXiv:2405.21060): L layers of
x + out_proj(gated_rmsnorm(SSD(silu(causal_conv(in_proj(rmsnorm(x))))) +
D x)), tied embeddings.  One SSD scan a layer, its B and C shared by all
heads (one group).  The mixer's weights, work and scan are also the
``hybrid`` family's."""
from __future__ import annotations

import math

from bench.reference import model as ref
from bench.reference.weights import lm_specs
from bench.work.flops import unembed_flops
from bench.work.ssd import ssd_work


def scan(m: dict):
    """(h, p, g, n, chunk) of the mixer's SSD scan: the published heads of
    ``ssm_head_dim`` over ``ssm_expand`` x d, one group."""
    di = m["ssm_expand"] * m["d_model"]
    return di // m["ssm_head_dim"], m["ssm_head_dim"], 1, m["ssm_state"], m["ssm_chunk"]


def mixer_specs(m: dict, res: float) -> dict:
    """The mixer's stacked leaves (``ssm.*``), in the published
    initializations (``mamba_ssm``): projections N(0, 1/fan_in), the output
    projection's scaled by ``res`` (1/sqrt of the residual writes), the
    steps' biases so that the steps start in [1e-3, 1e-1]."""
    d, L = m["d_model"], m["n_layers"]
    h, _, _, n, _ = scan(m)
    di, K = m["ssm_expand"] * d, m["ssm_conv"]
    conv_dim = di + 2 * n
    return {
        "ssm.in_proj": ((L, d, 2 * di + 2 * n + h), "normal", d ** -0.5),
        "ssm.conv_w": ((L, K, conv_dim), "normal", K ** -0.5),
        "ssm.conv_b": ((L, conv_dim), "zeros", 0),
        "ssm.A_log": ((L, h), "a_log", 0),
        "ssm.D": ((L, h), "ones", 0),
        "ssm.dt_bias": ((L, h), "dt_bias", 0),
        "ssm.gnorm": ((L, di), "ones", 0),
        "ssm.out_proj": ((L, di, d), "normal", di ** -0.5 * res),
    }


def mixer_flops(m: dict, B: int, S: int) -> int:
    """One layer's mixer: its two projections and the scan, the sequence
    padded to whole chunks as the scan runs it."""
    d, tokens = m["d_model"], B * S
    h, p, g, n, chunk = scan(m)
    di = m["ssm_expand"] * d
    s_pad = -(-S // chunk) * chunk
    return (2 * d * (2 * di + 2 * n + h) * tokens + 2 * di * d * tokens
            + ssd_work(B, s_pad, h, p, g, n, chunk, 2)[0])


def leaf_specs(m: dict) -> dict:
    lay = {"norm1": ((m["n_layers"], m["d_model"]), "ones", 0)}
    lay.update(mixer_specs(m, 1.0 / math.sqrt(m["n_layers"])))
    return lm_specs(m, lay)


def block(m, pl, x, window, mm):
    return x + ref.ssm_mixer(m, pl["ssm"], ref.rmsnorm(x, pl["norm1"], m["norm_eps"]), mm)


def hidden(m, params, tokens, mm=ref.f32_mm, remat=False):
    return ref.decoder(m, params, tokens, block, mm, remat)


def forward_flops(m: dict, B: int, S: int, *, unembed_all: bool = True) -> int:
    return m["n_layers"] * mixer_flops(m, B, S) + unembed_flops(m, B, S, unembed_all)


def ssd_scans(m: dict) -> list:
    return [(m["n_layers"], *scan(m))]
