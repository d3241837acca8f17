"""The plain SSD scan (Mamba-2's state-space duality, arXiv:2405.21060
§6), chunked and exact, in float32: a frozen copy of the program's own
plain version, so that a later change to the program cannot move it.
Differentiable by autograd."""
from __future__ import annotations

import math

import torch


def ssd(x, dt, A, B, C, *, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) after softplus; A: (h,) negative;
    B, C: (b, s, g, n) with h % g == 0; s a multiple of ``chunk``.
    Returns y: (b, s, h, p), all float32."""
    b, s, h, p = x.shape
    g = B.shape[2]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    rep = h // g
    xd = x * dt[..., None]
    Be = B.repeat_interleave(rep, dim=2)
    Ce = C.repeat_interleave(rep, dim=2)
    dA = dt * A
    state = x.new_zeros((b, h, p, B.shape[3]))
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xd_c, Be_c, Ce_c = xd[:, c0:c0 + chunk], Be[:, c0:c0 + chunk], Ce[:, c0:c0 + chunk]
        cums = torch.cumsum(dA[:, c0:c0 + chunk], dim=1)              # (b, l, h)
        seg = cums[:, :, None, :] - cums[:, None, :, :]                # (b, l, s, h)
        seg = seg.masked_fill(~tri[None, :, :, None], -math.inf)      # before exp
        scores = torch.einsum("blhn,bshn->blsh", Ce_c, Be_c) * seg.exp()
        y = torch.einsum("blsh,bshp->blhp", scores, xd_c)
        y = y + torch.einsum("blhn,bhpn,blh->blhp", Ce_c, state, cums.exp())
        decay = torch.exp(cums[:, -1:, :] - cums)
        upd = torch.einsum("blhp,blh,blhn->bhpn", xd_c, decay, Be_c)
        state = state * torch.exp(cums[:, -1, :])[:, :, None, None] + upd
        ys.append(y)
    return torch.cat(ys, 1)
