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
                  scale: Optional[float] = None, q_start: int = 0):
    """Materialized-scores attention. q: (B,Sq,H,D); k/v: (B,Skv,KV,Dk/Dv).
    Query i sits at position ``q_start + i`` among the keys' 0..Skv-1 for
    the masks (a block of rows of a longer sequence).  A query that sees no
    key gives 0, as the kernels do (``repro.kernels.ref`` gives NaN there).
    Differentiable: autograd through it is the plain version of the
    backward kernels (``csrc/flash_attention_bwd.cu``)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float())
    s = s * (scale if scale is not None else 1.0 / (D ** 0.5))
    iq = q_start + torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= jk <= iq
    if window:
        mask &= jk > iq - window
    s = s.masked_fill(~mask[None, None, None], -math.inf)
    m = s.amax(-1, keepdim=True)
    p = (s - torch.where(torch.isfinite(m), m, torch.zeros_like(m))).exp()
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bkgqj,bjkd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, -1).to(q.dtype)


# ------------------------------------------------------------------ SSD ref

def ssd_ref(x, dt, A, B, C, *, chunk: int = 256, initial_state=None):
    """Mamba-2 state-space duality (SSD), chunked exact algorithm: the plain
    version of ``csrc/ssd_scan.cu``.

    x: (b, s, h, p)   dt: (b, s, h)  post-softplus
    A: (h,)           negative real
    B, C: (b, s, g, n) with h % g == 0
    Returns (y: (b, s, h, p) in x.dtype, final_state: (b, h, p, n) float32).

    A Python loop over chunks carrying the float32 (b, h, p, n) state, so
    only one chunk's (l x l) decay block is materialized at a time.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}: "
                         f"pad it upstream")
    rep = h // g
    xd = (x * dt[..., None]).float()            # promotes as JAX does: bf16 * f32 -> f32
    Be = B.repeat_interleave(rep, dim=2).float()
    Ce = C.repeat_interleave(rep, dim=2).float()
    dA = (dt * A).float()                       # (b, s, h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xd_c, Be_c, Ce_c = xd[:, c0:c0 + chunk], Be[:, c0:c0 + chunk], Ce[:, c0:c0 + chunk]
        cums = torch.cumsum(dA[:, c0:c0 + chunk], dim=1)          # (b, l, h)
        seg = cums[:, :, None, :] - cums[:, None, :, :]            # (b, l, s, h)
        # mask BEFORE exp: above the diagonal seg is large and positive
        seg = seg.masked_fill(~tri[None, :, :, None], -math.inf)
        scores = torch.einsum("blhn,bshn->blsh", Ce_c, Be_c) * seg.exp()
        y = torch.einsum("blsh,bshp->blhp", scores, xd_c)          # intra-chunk
        y = y + torch.einsum("blhn,bhpn,blh->blhp", Ce_c, state, cums.exp())
        decay = torch.exp(cums[:, -1:, :] - cums)                  # (b, l, h)
        upd = torch.einsum("blhp,blh,blhn->bhpn", xd_c, decay, Be_c)
        state = state * torch.exp(cums[:, -1, :])[:, :, None, None] + upd
        ys.append(y)
    return torch.cat(ys, 1).to(x.dtype), state


def ssd_bwd_ref(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 256):
    """The plain version of ``csrc/ssd_scan_bwd.cu``: (dx, ddt, dA, dB, dC)
    of ``ssd_ref`` at (x, dt, A, B, C), given the output's gradient ``dy``
    and the final state's ``dstate`` (None when the state is unused), by
    autograd through ``ssd_ref``.  ``ssd_ref`` promotes x, B and C to
    float32 before any product, so the gradient flows in float32 here and is
    cast to each input's dtype once, at the end, as the kernel does.
    Autograd through bfloat16 leaves would instead round each head's dB and
    dC to bfloat16 before the sum over its group, several percent off where
    the heads' terms cancel."""
    leaves = [t.detach().float().requires_grad_() for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        y, state = ssd_ref(*leaves, chunk=chunk)
        outs, grads = [y], [dy.float()]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate.float())
        got = torch.autograd.grad(outs, leaves, grads)
    return tuple(g.to(t.dtype) for g, t in zip(got, (x, dt, A, B, C)))


def ssd_decode_ref(x, dt, A, B, C, state):
    """One-token SSD recurrence.  x: (b,h,p); dt: (b,h); B,C: (b,g,n);
    state: (b,h,p,n) float32.  Returns (y: (b,h,p) in x.dtype, state).

    The JAX package has no kernel for this step, so it stays torch ops on
    the card's decode path too, as ``layers.decode_attention`` does."""
    b, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    rep = h // g
    Be = B.repeat_interleave(rep, dim=1).float()            # (b, h, n)
    Ce = C.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt.float() * A.float())                 # (b, h)
    xd = (x * dt[..., None]).float()
    state = state * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xd, Be)
    y = torch.einsum("bhpn,bhn->bhp", state, Ce)
    return y.to(x.dtype), state


# ------------------------------------------------------------- quantize ref

def quantize_ref(x, *, group: int = 256):
    """Symmetric int8 group quantization along the last axis: the plain
    version of ``csrc/quantize.cu``.  ``scale = amax / 127`` (1.0 when the
    group is all zero), ``q = clip(round_half_even(x / scale), -127, 127)``
    with true divisions; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The divisor 127 is a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, one ulp off
    the quotient in some groups.

    Returns (q: int8 same shape, scales: float32 (..., n_groups))."""
    shape = x.shape
    if shape[-1] % group:
        raise ValueError(f"last dim of {tuple(shape)} is not a multiple of group {group}")
    xg = x.reshape(*shape[:-1], shape[-1] // group, group).float()
    amax = xg.abs().amax(-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(xg / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(shape), scale


def dequantize_ref(q, scale, *, group: int = 256, dtype=torch.float32):
    """Inverse of :func:`quantize_ref` up to its rounding: ``q * scale``."""
    shape = q.shape
    qg = q.reshape(*shape[:-1], shape[-1] // group, group).float()
    return (qg * scale[..., None]).reshape(shape).to(dtype)
