"""Model FLOPs of a configuration, from its published sizes: the weight
products (projections, MLP, unembedding), the SSD scan (:func:`ssd_work`'s
operations) and attention's two products over the (query, key) pairs that
its masks leave visible.  Convolutions, norms and other elementwise work
are not counted; a training step counts its backward at twice the forward
and none of remat's recomputation.  Each family's ``forward_flops``
(``bench/families/``) sums the counts of its layers from the shared ones
here.

Worked examples (``train_step_flops(m, 1, 4096) / 4096``, FLOPs a token):

* mamba2-780m: per layer 2·1536·6448 (in_proj) + 2·3072·1536 (out_proj)
  + the scan's 2.43 M, times 48, plus 2·1536·50280 for the unembedding:
  1.673 GFLOP forward, 5.02 GFLOP a trained token;
* hymba-1.5b: per layer 12.29 M of attention projections, 52.84 M of
  MLP, 30.98 M of SSM projections and 1.03 M of scan, plus attention's
  pairs (896.5 visible on average through a 1024 window, 2048.5 on the
  three global layers, 6400 FLOPs a pair), times 32, plus the 102.4 M
  unembedding: 3.417 GFLOP forward, 10.25 GFLOP a trained token.

A prefill unembeds only each prompt's last position
(``forward_flops(..., unembed_all=False)``): at 1 x 4096, mamba2-780m's
1.519 GFLOP a token and hymba-1.5b's 3.314.
"""
from __future__ import annotations

from bench import families


def visible_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs of a length-``S`` sequence, each query
    seeing only the last ``window`` keys when ``window`` is non-zero."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def gqa_proj_flops(m: dict, tokens: int) -> int:
    """GQA's q, k, v and output projections over ``tokens``."""
    d, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return 2 * d * (2 * H * hd + 2 * KV * hd) * tokens


def attention_pair_flops(m: dict, B: int, S: int, window: int) -> int:
    """Attention's two products (scores, weighted values) over the visible
    pairs of ``B`` sequences of ``S`` tokens."""
    return 2 * B * m["n_heads"] * (2 * m["head_dim"]) * visible_pairs(S, window)


def swiglu_flops(m: dict, tokens: int) -> int:
    """The SwiGLU MLP's three products over ``tokens``."""
    return 3 * 2 * m["d_model"] * m["d_ff"] * tokens


def unembed_flops(m: dict, B: int, S: int, unembed_all: bool) -> int:
    """The unembedding over every position, or over each sequence's last
    one when ``unembed_all`` is False."""
    return 2 * m["d_model"] * m["vocab"] * (B * S if unembed_all else B)


def forward_flops(m: dict, B: int, S: int, *, unembed_all: bool = True) -> int:
    """The forward's FLOPs over ``B`` sequences of ``S`` tokens (the
    family's count); with ``unembed_all`` False the unembedding counts for
    each sequence's last position only, as a prefill computes it."""
    return families.of(m).forward_flops(m, B, S, unembed_all=unembed_all)


def train_step_flops(m: dict, B: int, S: int) -> int:
    """A training step's model FLOPs: the forward and a backward of twice
    its operations."""
    return 3 * forward_flops(m, B, S)
