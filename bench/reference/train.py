"""The reference's training steps: the loss's gradient in float32 (summed
over blocks of rows, so a long batch fits), every gradient leaf int8
group-quantized and dequantized, clipped by the global norm, and a plain
AdamW update (decoupled weight decay, bias-corrected moments).  Reads back
what a training cell's check compares: each step's loss, each leaf's
gradient norm as the optimizer gets it at step 1, and each leaf's change
after the last step."""
from __future__ import annotations

import torch

from bench.reference import model as ref
from bench.reference.weights import draw, draw_leaf, flat_items


def quantize_dequantize(g, group: int):
    """``g`` through symmetric int8 groups of ``group`` values along the
    flattened leaf (zero-padded to whole groups): scale = amax / 127 (1
    for an all-zero group), round half to even, clip to [-127, 127]."""
    flat = g.reshape(-1)
    pad = -flat.numel() % group
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    xg = flat.reshape(-1, group)
    amax = xg.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(xg / scale).clamp_(-127, 127)
    return (q * scale).reshape(-1)[:g.numel()].reshape(g.shape)


def grads(m, params, tokens, row_block: int, mm=ref.f32_mm):
    """(mean loss, {path: gradient}) of the next-token cross-entropy of
    ``tokens`` (B, S), ``row_block`` rows at a time."""
    leaves = dict(flat_items(params))
    for t in leaves.values():
        t.requires_grad_(True)
        t.grad = None
    total = tokens.shape[0] * (tokens.shape[1] - 1)
    loss = 0.0
    try:
        for r0 in range(0, tokens.shape[0], row_block):
            s, _ = ref.ce_sum(m, params, tokens[r0:r0 + row_block], mm)
            (s / total).backward()
            loss += float(s.detach()) / total
        return loss, {k: t.grad.detach() for k, t in leaves.items()}
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None


def adamw_step(opt: dict, params, state, g, step: int):
    """One AdamW step in place over the flat dicts ``params`` and ``state``
    ({"m": {...}, "v": {...}}); ``g`` the clipped gradient."""
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        m = state["m"][k].mul_(b1).add_(g[k], alpha=1 - b1)
        v = state["v"][k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
        delta = (m / c1) / (torch.sqrt(v / c2) + opt["eps"]) + opt["weight_decay"] * p
        p.sub_(opt["lr"] * delta)


@torch.no_grad()
def readings(m, opt: dict, group: int, seed: int, batches, device, *, row_block: int,
             mm=ref.f32_mm, rows=None):
    """Train the seed's weights over ``batches`` (token tensors (B, S)),
    as the program's step does.  Returns {"loss": [per step],
    "grad": {path: the clipped gradient at step 1, on the host},
    "grad_norm": {path: its norm},
    "raw_grad_norm": {path: norm of the plain gradient at step 1},
    "change_norm": {path: norm of the last step's weights minus the
    first}}.  ``rows``, when given, keeps only those rows of each batch
    (a planted fault: part of the batch left out)."""
    params = draw(m, seed, device)
    flat = dict(flat_items(params))
    state = {"m": {k: torch.zeros_like(p) for k, p in flat.items()},
             "v": {k: torch.zeros_like(p) for k, p in flat.items()}}
    out = {"loss": []}
    for step, tokens in enumerate(batches, 1):
        if rows is not None:
            tokens = tokens[rows]
        with torch.enable_grad():
            loss, g = grads(m, params, tokens, row_block, mm)
        out["loss"].append(loss)
        gq = {k: quantize_dequantize(v, group) for k, v in g.items()}
        gn = torch.sqrt(sum(torch.sum(v * v) for v in gq.values()))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gn, min=1e-9), max=1.0)
        gq = {k: v * scale for k, v in gq.items()}
        if step == 1:
            out["grad"] = {k: v.to("cpu") for k, v in gq.items()}
            out["grad_norm"] = {k: float(torch.linalg.vector_norm(v)) for k, v in gq.items()}
            out["raw_grad_norm"] = {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}
        del g
        adamw_step(opt, flat, state, gq, step)
        del gq
    del state
    out["change_norm"] = {k: float(torch.linalg.vector_norm(p - draw_leaf(m, seed, k, device)))
                          for k, p in flat.items()}
    return out
