"""Mamba-2 (SSD) block: in-proj -> causal depthwise conv -> SSD scan ->
gated RMSNorm -> out-proj.  Prefill and forward use the chunked SSD
algorithm (``repro_torch.kernels.ops.ssd``: the hand-written kernel on the
card, its plain version on the CPU); decode is the O(1)-state recurrence."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_decode_ref
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    g, n = 1, cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return di, g, n, h, conv_dim


def ssm_init(cfg: ModelConfig, gen: torch.Generator):
    di, g, n, h, conv_dim = _dims(cfg)
    d, dev = cfg.d_model, gen.device
    in_proj = dense_init(gen, (d, 2 * di + 2 * g * n + h), d, cfg.pdt)
    conv_w = dense_init(gen, (cfg.ssm_conv, conv_dim), cfg.ssm_conv, cfg.pdt)
    out_proj = dense_init(gen, (di, d), di, cfg.pdt)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(cfg.pdt),
        "D": torch.ones((h,), dtype=cfg.pdt, device=dev),
        "dt_bias": torch.zeros((h,), dtype=cfg.pdt, device=dev),
        "gnorm": torch.ones((di,), dtype=cfg.pdt, device=dev),
        "out_proj": out_proj,
    }


def _split(cfg, zxbcdt):
    di, g, n, h, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xBC, dt


def causal_conv(xBC, w, b):
    """Depthwise causal conv along sequence. xBC: (B,S,C); w: (K,C).  The
    same sum of K shifted products as the JAX version: ``F.conv1d`` would
    go through cuDNN, in TF32 by default for float32."""
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b[None, None, :])


def ssm_forward(cfg: ModelConfig, p, x, *, return_state=False):
    """Full-sequence path.  x: (B, S, d_model).  With ``return_state``,
    returns (out, (ssm state (B,h,P,n) float32, conv state (B,K-1,conv_dim):
    the last K-1 raw, pre-conv channels))."""
    di, g, n, h, conv_dim = _dims(cfg)
    B_, S, _ = x.shape
    P = cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC_raw, dt = _split(cfg, zxbcdt)
    xBC = causal_conv(xBC_raw, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs = xBC[..., :di].reshape(B_, S, h, P)          # views: the kernel reads strides
    Bs = xBC[..., di:di + g * n].reshape(B_, S, g, n)
    Cs = xBC[..., di + g * n:].reshape(B_, S, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xs_res = xs                          # un-padded, for the D skip term
    # The JAX version's ssm_pad_heads_to and sharding constraints only steer
    # how heads are split across a mesh; on one device they change nothing
    # (and mamba2-780m's 48 heads are a multiple of 16 anyway).
    # pad sequence to a chunk multiple: dt = 0 there leaves y and the state
    # as they are.  A prompt shorter than ssm_chunk gets one chunk rounded up
    # to a multiple of 64, the kernel's wgmma tile, so that every bf16
    # prefill takes that route (ops.ssd_route); the JAX version uses S.
    chunk = min(cfg.ssm_chunk, -(-S // 64) * 64)
    pad = (-S) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bs = F.pad(Bs, (0, 0, 0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = ops.ssd(xs, dt, A, Bs, Cs, chunk=chunk)
    y = y[:, :S]
    y = y + xs_res * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, S, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        # conv state: the last (K-1) raw (pre-conv) channels, left-padded with
        # zeros when the prompt is shorter; JAX recomputes them from the tail
        # of x, which is the same product row for row
        K = cfg.ssm_conv
        tail = xBC_raw[:, -(K - 1):] if S >= K - 1 else F.pad(xBC_raw, (0, 0, K - 1 - S, 0))
        return out, (state, tail)
    return out


def ssm_decode(cfg: ModelConfig, p, x, state, conv_state):
    """One-token step.  x: (B, 1, d); state: (B,h,P,n) float32;
    conv_state: (B, K-1, conv_dim) raw (pre-activation) conv inputs.
    Returns (out, new state, new conv state)."""
    di, g, n, h, conv_dim = _dims(cfg)
    P = cfg.ssm_head_dim
    B_ = x.shape[0]
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC_new, dt = _split(cfg, zxbcdt)            # (B,1,·)
    window = torch.cat([conv_state, xBC_new], dim=1)   # (B,K,conv)
    w = p["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(x.dtype)
    xBC = F.silu(conv_out)                          # (B, conv_dim)
    xs = xBC[..., :di].reshape(B_, h, P)
    Bs = xBC[..., di:di + g * n].reshape(B_, g, n)
    Cs = xBC[..., di + g * n:].reshape(B_, g, n)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, state = ssd_decode_ref(xs, dtv, A, Bs, Cs, state)
    y = y + xs * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(B_, 1, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, state, window[:, 1:, :]


def ssm_init_cache(cfg: ModelConfig, batch, dtype, device="cuda"):
    di, g, n, h, conv_dim = _dims(cfg)
    return (torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device))
