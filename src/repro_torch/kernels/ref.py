"""Plain PyTorch oracles for the hand-written kernels.

They are the semantic ground truth: the CPU tests hold them against the
JAX oracles in ``repro.kernels.ref``, ``ops`` runs them for tensors that
lie on the CPU, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


# ------------------------------------------------------------ attention ref

def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None):
    """Materialized-scores attention. q: (B,Sq,H,D); k/v: (B,Skv,KV,Dk/Dv).
    A query that sees no key gives 0, as the kernels do (``repro.kernels.ref``
    gives NaN there)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float())
    s = s * (scale if scale is not None else 1.0 / (D ** 0.5))
    iq = torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= jk <= iq
    if window:
        mask &= jk > iq - window
    s = s.masked_fill(~mask[None, None, None], -math.inf)
    m = s.amax(-1, keepdim=True)
    p = (s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))).exp_()
    p = p.div_(p.sum(-1, keepdim=True).clamp_(min=1e-30))
    o = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)
