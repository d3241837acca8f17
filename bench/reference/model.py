"""The plain float32 reference's building blocks, written from the papers
and importing nothing of the program: the products, RMSNorm, the causal
conv, the Mamba-2 mixer (arXiv:2405.21060), GQA attention with NeoX rope
and an optional causal window, the SwiGLU MLP, the stack of layers, the
unembedding and the cross-entropy.  Each model family
(``bench/families/<family>.py``) builds its layer from them; :func:`hidden`
runs the family's forward.

Every product goes through ``mm``: ``torch.matmul`` in float32, or
:func:`fp8_mm` for the control, which puts both operands through float8
e4m3 first.  Layers run one after another, under activation checkpointing
when asked, so a long sequence fits beside its gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import families
from bench.reference.ssd import ssd

FP8_MAX = 448.0


def f32_mm(a, w):
    return a @ w


def _fp8(t):
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())          # rounded forward, straight-through backward


def fp8_mm(a, w):
    """The product of ``a`` and ``w`` each rounded to float8 e4m3 under
    one scale a tensor, accumulated in float32."""
    return _fp8(a) @ _fp8(w)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _conv_silu(xBC, w, b):
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    S = xBC.shape[1]
    return F.silu(sum(pad[:, i:i + S] * w[i] for i in range(K)) + b)


def ssm_mixer(m, p, x, mm):
    """The Mamba-2 mixer on the normed ``x`` (B, S, d)."""
    B_, S, _ = x.shape
    di = m["ssm_expand"] * m["d_model"]
    n, P, chunk = m["ssm_state"], m["ssm_head_dim"], m["ssm_chunk"]
    h = di // P
    zxbcdt = mm(x, p["in_proj"])
    z, xBC, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]
    xBC = _conv_silu(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(B_, S, h, P)
    Bm = xBC[..., di:di + n].reshape(B_, S, 1, n)
    Cm = xBC[..., di + n:].reshape(B_, S, 1, n)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    pad = -S % chunk                      # zeros after the end change no earlier row
    if pad:
        xs_p, Bm, Cm, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                            for t in (xs, Bm, Cm, dt))
    else:
        xs_p = xs
    y = ssd(xs_p, dt, A, Bm, Cm, chunk=chunk)[:, :S]
    y = (y + xs * p["D"][:, None]).reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z), p["gnorm"], m["norm_eps"])
    return mm(y, p["out_proj"])


def _rope(x, theta):
    """NeoX half rotation of x (B, S, H, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(m, p, x, window, mm, q_block=1024):
    """GQA over the normed ``x``, causal, over the last ``window`` keys
    when ``window`` is non-zero; scores in blocks of ``q_block`` queries."""
    B_, S, _ = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    G = H // KV
    q = _rope(mm(x, p["wq"]).reshape(B_, S, H, hd), m["rope_theta"])
    k = _rope(mm(x, p["wk"]).reshape(B_, S, KV, hd), m["rope_theta"])
    v = mm(x, p["wv"]).reshape(B_, S, KV, hd)
    q = q.reshape(B_, S, KV, G, hd)
    j = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, q_block):
        qb = q[:, q0:q0 + q_block]
        i = torch.arange(q0, q0 + qb.shape[1], device=x.device)[:, None]
        mask = j[None, :] <= i
        if window:
            mask = mask & (j[None, :] > i - window)
        s = torch.einsum("bqkgd,bjkd->bkgqj", qb, k) / math.sqrt(hd)
        pr = torch.softmax(s.masked_fill(~mask, -math.inf), -1)
        outs.append(torch.einsum("bkgqj,bjkd->bqkgd", pr, v))
    o = torch.cat(outs, 1).reshape(B_, S, H * hd)
    return mm(o, p["wo"])


def windows(m):
    """Each layer's attention window, 0 for full attention."""
    L = m["n_layers"]
    return [0 if (not m["swa_window"] or i in m["global_layers"]) else m["swa_window"]
            for i in range(L)]


def swiglu(p, x, mm):
    """The SwiGLU MLP (``wg``, ``wu``, ``wd``) on the normed ``x``."""
    return mm(F.silu(mm(x, p["wg"])) * mm(x, p["wu"]), p["wd"])


def _layers(tree, n):
    """Each layer's views of the stacked leaves: one ``unbind`` a leaf, whose
    backward stacks the layers' gradients once (indexing would add a
    full-size gradient for every layer)."""
    per = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def decoder(m, params, tokens, block, mm=f32_mm, remat=False):
    """The final normed hidden states (B, S, d) of ``tokens`` (B, S) through
    the embedding and ``block(m, layer_params, x, window, mm)`` over the
    stacked layers, with each layer's window (:func:`windows`)."""
    x = params["embed"][tokens.long()]
    for pl, w in zip(_layers(params["layers"], m["n_layers"]), windows(m)):
        if remat:
            x = checkpoint(block, m, pl, x, w, mm, use_reentrant=False)
        else:
            x = block(m, pl, x, w, mm)
    return rmsnorm(x, params["final_norm"], m["norm_eps"])


def hidden(m, params, tokens, mm=f32_mm, remat=False):
    """The final normed hidden states (B, S, d) of ``tokens`` (B, S): the
    forward of ``m``'s family."""
    return families.of(m).hidden(m, params, tokens, mm, remat)


def unembed(m, params, x, mm=f32_mm):
    un = params["embed"].T if m["tie_embeddings"] else params["unembed"]
    return mm(x, un)


def ce_sum(m, params, tokens, mm=f32_mm):
    """The summed next-token cross-entropy of ``tokens`` (B, S) and the
    number of terms in it."""
    x = hidden(m, params, tokens, mm, remat=True)[:, :-1]
    logits = unembed(m, params, x, mm)
    tgt = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1),
                           reduction="sum"), tgt.numel()
