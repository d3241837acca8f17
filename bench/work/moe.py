"""Operations and bytes of the held experts' grouped products in one MoE
block of the ``pattern`` family (``models/moe.py``'s dropless path): each
(token, k) pair on a held expert takes an up product (d to f) and a down
product (f to d).  The pairs are the held share of all of them, tokens · k
· held / router experts, which is what the routing gives on average (the
count for given inputs depends on the data).  Bytes: the held experts'
bf16 weights read once, and each pair's bf16 rows in and out of both
products.

Worked example, nemotron-3-nano-30b-a3b at a 16 x 8192 prefill (131,072
tokens, top 6, 64 of 128 experts held, d 2688, f 1856)::

    >>> moe_work(m, 131072)
    (7846905249792, 8424259584)

393,216 pairs: bound by the operations, 7.93 ms a block at 989 TFLOP/s
(the bytes take 2.51 ms at 3.35 TB/s).
"""
from __future__ import annotations


def moe_work(m: dict, tokens: int, itemsize: int = 2):
    """(operations, bytes) of one MoE block's held experts over ``tokens``."""
    d, f = m["d_model"], m["d_expert"]
    pairs = tokens * m["top_k"] * m["n_experts"] // m["router_experts"]
    flops = pairs * 2 * 2 * d * f
    nbytes = (m["n_experts"] * 2 * d * f + pairs * 2 * (d + f)) * itemsize
    return flops, nbytes
