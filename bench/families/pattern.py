"""The ``pattern`` family, NVIDIA Nemotron-H as NVIDIA-Nemotron-3-Nano-30B-A3B
publishes it (``config.json`` and ``modeling_nemotron_h.py``): a stack of
blocks x + mixer(rmsnorm(x)), the mixer of each set by ``block_pattern``:

* ``M``, Mamba-2 (arXiv:2405.21060) with ``ssm_n_heads`` heads of
  ``ssm_head_dim``, B and C in ``ssm_groups`` groups (head i reads group
  i // (h / g)), a causal conv with a bias over x, B and C, and the gated
  RMSNorm rmsnorm(y · silu(z)) taken over each group's channels on their
  own;
* ``E``, a mixture of experts: sigmoid scores of a float32 router over
  ``router_experts`` experts; the top k by score plus a correction bias,
  weighted by their unbiased scores normalised over the k and scaled by
  ``routed_scale``; relu² experts, down(relu(up(x))²), with no gate; one
  shared relu² expert of ``d_shared`` added for every token; nothing
  dropped;
* ``*``, causal GQA attention with no rotary embedding (the modeling code
  applies none; the config's ``rope_theta`` is not read).

The cut: of the router's experts only 0..``n_experts``-1 are held (a card's
share of expert parallelism).  A pair routed to another expert adds nothing
here, in the program and in this reference alike: its part would come back
from the card that holds it.  Every other weight is whole.

Departures from the published model: random weights (below);
``e_score_correction_bias`` drawn small and non-zero (N(0, 0.05²)) so that
the choice and the weights differ, where a checkpoint holds learned
values; the conv's bias drawn zero, as the ``ssm`` family's.

Weights.  The layers' leaves are drawn in float32 and, for a configuration
with bfloat16 parameters, rounded to bfloat16 (``INITS``' ``bf16_*``
kinds), each stacked leaf one layer at a time so that no float32 copy of a
whole expert leaf is alive; the router and its bias stay float32, as the
program keeps them.  The embedding, unembedding and final norm are
``lm_specs``' float32 leaves: ``reference.model.unembed`` multiplies in the
leaves' dtype.  :func:`hidden` casts each block's leaves to float32 as it
runs them.  Initializations: projections N(0, 1/fan_in), the projections
that write into the residual stream (Mamba's and attention's output, the
experts' down projections) scaled by 1/sqrt(blocks), the routed experts'
down projections by ``ROUTED_WRITE`` (a tenth) besides, the steps' biases
so that the steps start in [1e-3, 1e-1], A_log log(1..16), D and the
norms 1.  The experts' down projections are centred over their hidden
axis: relu² is never negative, and a random down projection of its mean
writes a vector common to every token, which grows with depth and pulls
every token's router onto the same few experts.  Centred, the most pairs on
one expert fell from a median of 6.7 to 4.3 times the mean over the MoE
blocks of a 16 x 8192 prefill, and the share of pairs on held experts,
which sets the prefill's time, spread over 0.482-0.503 across four seeds
where it had over 0.482-0.518 (``PERF.md`` §2).

Why the routed experts write at a tenth: on random weights a token's
top-6 choice has no margin, and one expert swapped at the boundary moves
the token's state by as much as a whole expert's output, which moves the
next blocks' choices in turn.  At the full scale bf16's rounding alone
changed the top-6 of 5.6% of a 1024-token prompt's tokens at the first MoE
block and of 97% at the last, and the served gap of sound runs (3.01-3.31)
read as the float8 control's (3.90), so the check could not tell one
precision from the other.  At a tenth, through the cell's own
``served_gap`` (NVIDIA H100 80GB HBM3, 700 W; ``PERF.md`` §2), sound runs
read up to 0.368 and the float8 control from 1.31, while the routed
path's planted faults (``harness/pattern_faults.py``: its part left out;
each pair's expert one over) read 0.71-1.07 and 1.18-2.14.  At two tenths
a sound run already read 0.445 and at three tenths 1.29, against controls
of 1.65 and 1.73: the check then tells bf16 from float8 less well.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import model as ref
from bench.reference.ssd import ssd
from bench.reference.weights import INITS as SHARED_INITS
from bench.reference.weights import lm_specs
from bench.work.flops import attention_pair_flops, gqa_proj_flops, unembed_flops
from bench.work.moe import moe_work
from bench.work.ssd import ssd_work

KINDS = {"M": "mamba", "E": "moe", "*": "attention"}   # the program's stacks, by letter
ROUTED_WRITE = 0.1      # the routed experts' down projections' extra scale (above)


def _rounded(base, by_layer: bool):
    """The init kind ``base`` rounded to bfloat16; with ``by_layer`` drawn
    one leading index (one layer) at a time."""
    def init(shape, std, gen, device):
        if not by_layer:
            return base(shape, std, gen, device).to(torch.bfloat16)
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        for i in range(shape[0]):
            out[i] = base(shape[1:], std, gen, device)
        return out
    return init


def _centred(shape, std, gen, device):
    """N(0, std²) with the mean over the second-last (hidden) axis taken
    out: a relu² MLP's down projection, through which relu²'s mean, the
    same for every token, writes nothing into the residual stream."""
    w = SHARED_INITS["normal"](shape, std, gen, device)
    return w.sub_(w.mean(-2, keepdim=True))


INITS = {"centred": _centred, "bf16_centred": _rounded(_centred, True),
         "bf16_normal": _rounded(SHARED_INITS["normal"], True),
         **{f"bf16_{k}": _rounded(SHARED_INITS[k], False)
            for k in ("ones", "zeros", "a_log", "dt_bias")}}


def counts(m: dict) -> dict:
    """{kind: blocks of it}, for the kinds in the pattern."""
    return {kind: m["block_pattern"].count(ch) for ch, kind in KINDS.items()
            if ch in m["block_pattern"]}


def scan(m: dict):
    """(h, p, g, n, chunk) of the Mamba blocks' SSD scan."""
    return m["ssm_n_heads"], m["ssm_head_dim"], m["ssm_groups"], m["ssm_state"], m["ssm_chunk"]


def leaf_specs(m: dict) -> dict:
    d, L = m["d_model"], m["n_layers"]
    kind = (lambda k: f"bf16_{k}") if m["param_dtype"] == "bfloat16" else (lambda k: k)
    res = 1.0 / math.sqrt(L)              # one residual write a block
    n = counts(m)
    lay = {}
    if "mamba" in n:
        N = n["mamba"]
        h, p, g, st, _ = scan(m)
        di, conv = h * p, h * p + 2 * g * st
        lay.update({
            "mamba.norm1": ((N, d), kind("ones"), 0),
            "mamba.ssm.in_proj": ((N, d, 2 * di + 2 * g * st + h), kind("normal"), d ** -0.5),
            "mamba.ssm.conv_w": ((N, m["ssm_conv"], conv), kind("normal"), m["ssm_conv"] ** -0.5),
            "mamba.ssm.conv_b": ((N, conv), kind("zeros"), 0),
            "mamba.ssm.A_log": ((N, h), kind("a_log"), 0),
            "mamba.ssm.D": ((N, h), kind("ones"), 0),
            "mamba.ssm.dt_bias": ((N, h), kind("dt_bias"), 0),
            "mamba.ssm.gnorm": ((N, di), kind("ones"), 0),
            "mamba.ssm.out_proj": ((N, di, d), kind("normal"), di ** -0.5 * res),
        })
    if "moe" in n:
        N, E, R = n["moe"], m["n_experts"], m["router_experts"]
        f, fs = m["d_expert"], m["d_shared"]
        lay.update({
            "moe.norm1": ((N, d), kind("ones"), 0),
            "moe.moe.router": ((N, d, R), "normal", d ** -0.5),
            "moe.moe.router_bias": ((N, R), "normal", 0.05),
            "moe.moe.wu": ((N, E, d, f), kind("normal"), d ** -0.5),
            "moe.moe.wd": ((N, E, f, d), kind("centred"), f ** -0.5 * res * ROUTED_WRITE),
            "moe.moe.shared_wu": ((N, d, fs), kind("normal"), d ** -0.5),
            "moe.moe.shared_wd": ((N, fs, d), kind("centred"), fs ** -0.5 * res),
        })
    if "attention" in n:
        N, H, KV, hd = n["attention"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
        lay.update({
            "attention.norm1": ((N, d), kind("ones"), 0),
            "attention.attn.wq": ((N, d, H * hd), kind("normal"), d ** -0.5),
            "attention.attn.wk": ((N, d, KV * hd), kind("normal"), d ** -0.5),
            "attention.attn.wv": ((N, d, KV * hd), kind("normal"), d ** -0.5),
            "attention.attn.wo": ((N, H * hd, d), kind("normal"), (H * hd) ** -0.5 * res),
        })
    return lm_specs(m, lay)


# ------------------------------------------------------------------ mixers

def mamba(m, p, x, mm):
    """The grouped Mamba-2 mixer on the normed ``x`` (B, S, d)."""
    B_, S, _ = x.shape
    h, P, g, n, chunk = scan(m)
    di = h * P
    zxbcdt = mm(x, p["in_proj"])
    z, xBC, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * n], zxbcdt[..., 2 * di + 2 * g * n:]
    K = p["conv_w"].shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = F.silu(sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"])
    xs = xBC[..., :di].reshape(B_, S, h, P)
    Bm = xBC[..., di:di + g * n].reshape(B_, S, g, n)
    Cm = xBC[..., di + g * n:].reshape(B_, S, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    tail = -S % chunk                    # zeros after the end change no earlier row
    args = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, tail)) for t in (xs, dt, Bm, Cm)]
    y = ssd(args[0], args[1], A, args[2], args[3], chunk=chunk)[:, :S]
    y = ((y + xs * p["D"][:, None]) * F.silu(z.reshape(B_, S, h, P))).reshape(B_, S, g, di // g)
    y = ref.rmsnorm(y, p["gnorm"].view(g, di // g), m["norm_eps"]).reshape(B_, S, di)
    return mm(y, p["out_proj"])


def attention(m, p, x, mm, q_block=1024):
    """Causal GQA over the normed ``x``, no positions; scores in blocks of
    ``q_block`` queries."""
    B_, S, _ = x.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, p["wq"]).reshape(B_, S, KV, H // KV, hd)
    k = mm(x, p["wk"]).reshape(B_, S, KV, hd)
    v = mm(x, p["wv"]).reshape(B_, S, KV, hd)
    j = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, q_block):
        qb = q[:, q0:q0 + q_block]
        i = torch.arange(q0, q0 + qb.shape[1], device=x.device)[:, None]
        s = torch.einsum("bqkgd,bjkd->bkgqj", qb, k) / math.sqrt(hd)
        pr = torch.softmax(s.masked_fill(j[None, :] > i, -math.inf), -1)
        outs.append(torch.einsum("bkgqj,bjkd->bqkgd", pr, v))
    return mm(torch.cat(outs, 1).reshape(B_, S, H * hd), p["wo"])


def route(m, p, xt, mm):
    """(w (T, K), idx (T, K)) of the tokens ``xt`` (T, d): sigmoid scores,
    the top k by score plus the correction bias, weighted by the scores
    normalised over the k and scaled by ``routed_scale``."""
    scores = torch.sigmoid(mm(xt, p["router"]))
    idx = torch.topk(scores + p["router_bias"], m["top_k"], dim=-1).indices
    w = scores.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"], idx


def relu2(x, wu, wd, mm):
    return mm(F.relu(mm(x, wu)) ** 2, wd)


def routed(m, p, xt, mm, first=0):
    """The routed experts' part of the layer for the tokens ``xt`` (T, d),
    from the experts ``p["wu"]``/``p["wd"]`` hold, which are the router's
    experts first, first + 1, ...: each pair on one of them is its
    expert's output times its weight; every other pair adds nothing."""
    w, idx = route(m, p, xt, mm)
    T, K = idx.shape
    yk = xt.new_zeros((T, K, xt.shape[1]))
    for e in range(p["wu"].shape[0]):
        tok, slot = torch.where(idx == first + e)
        if tok.numel():
            yk[tok, slot] = relu2(xt[tok], p["wu"][e], p["wd"][e], mm)
    return (w[..., None] * yk).sum(1)


def moe(m, p, x, mm):
    """The MoE mixer on the normed ``x`` (B, S, d): the held experts' part
    and the shared expert."""
    xt = x.reshape(-1, x.shape[-1])
    out = routed(m, p, xt, mm) + relu2(xt, p["shared_wu"], p["shared_wd"], mm)
    return out.view(x.shape)


MIXERS = {"mamba": ("ssm", mamba), "moe": ("moe", moe), "attention": ("attn", attention)}


# ------------------------------------------------------------------ stack

def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def _block(m, kind, pl, x, mm):
    key, mixer = MIXERS[kind]
    pl = _f32(pl)
    return x + mixer(m, pl[key], ref.rmsnorm(x, pl["norm1"], m["norm_eps"]), mm)


def blocks(m, layers):
    """(kind, its leaves) of each block of the pattern, in order."""
    per = {kind: ref._layers(layers[kind], N) for kind, N in counts(m).items()}
    seen = dict.fromkeys(per, 0)
    for ch in m["block_pattern"]:
        kind = KINDS[ch]
        yield kind, per[kind][seen[kind]]
        seen[kind] += 1


def hidden(m, params, tokens, mm=ref.f32_mm, remat=False):
    x = params["embed"][tokens.long()].float()
    for kind, pl in blocks(m, params["layers"]):
        if remat:
            x = checkpoint(_block, m, kind, pl, x, mm, use_reentrant=False)
        else:
            x = _block(m, kind, pl, x, mm)
    return ref.rmsnorm(x, params["final_norm"].float(), m["norm_eps"])


# ------------------------------------------------------------------- work

def moe_flops(m: dict, tokens: int) -> int:
    """One MoE block: the router, the held share of the routed pairs
    (``work.moe.moe_work``: tokens · k · held / router experts, each an up
    and a down product) and the shared expert."""
    d = m["d_model"]
    return (2 * d * m["router_experts"] * tokens + moe_work(m, tokens)[0]
            + 2 * 2 * d * m["d_shared"] * tokens)


def mamba_flops(m: dict, B: int, S: int) -> int:
    """One Mamba block: its two projections and the scan, the sequence
    padded to whole chunks as the scan runs it."""
    d, tokens = m["d_model"], B * S
    h, p, g, n, chunk = scan(m)
    di = h * p
    return (2 * d * (2 * di + 2 * g * n + h) * tokens + 2 * di * d * tokens
            + ssd_work(B, -(-S // chunk) * chunk, h, p, g, n, chunk, 2)[0])


def forward_flops(m: dict, B: int, S: int, *, unembed_all: bool = True) -> int:
    n, tokens = counts(m), B * S
    return (n.get("mamba", 0) * mamba_flops(m, B, S) + n.get("moe", 0) * moe_flops(m, tokens)
            + n.get("attention", 0) * (gqa_proj_flops(m, tokens)
                                       + attention_pair_flops(m, B, S, 0))
            + unembed_flops(m, B, S, unembed_all))


def ssd_scans(m: dict) -> list:
    n = counts(m).get("mamba", 0)
    return [(n, *scan(m))] if n else []
