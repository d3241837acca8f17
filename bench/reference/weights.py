"""The benchmark's weights: drawn from ``--seed`` on the device, one call a
leaf, in float32, in the layout of the served and trained program (the
layers stacked ``(L, ...)``), and handed alike to the program and to the
reference.

Each leaf has a generator of its own, seeded from (seed, the leaf's path),
so one leaf can be drawn again without the others: the reference redraws
the initial weights leaf by leaf to measure how far training moved them.
"""
from __future__ import annotations

import hashlib
import math

import torch


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for the leaf at ``path`` of run ``seed``."""
    digest = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(m: dict) -> dict:
    """{path: (shape, init, std)} of the model ``m`` (a configuration
    file's ``model``): init is "normal" (N(0, std^2)), "ones", "zeros",
    "half" (0.5), "a_log" (log of 1..16 spread over the SSM heads) or
    "dt_bias" (softplus^-1 of a step drawn log-uniform in [1e-3, 1e-1]).

    The published initializations (Mamba-2's ``mamba_ssm``, GPT-2's): the
    embedding N(0, 0.02^2), each projection N(0, 1/fan_in), the
    projections that write into the residual stream scaled by
    1/sqrt(writes a layer x layers), and the SSM's step biases so that the
    steps start in [1e-3, 1e-1]."""
    d, L, V = m["d_model"], m["n_layers"], m["vocab"]
    hybrid = m["family"] == "hybrid"
    if m["family"] not in ("ssm", "hybrid"):
        raise ValueError(f"no weights for family {m['family']!r}")
    res = 1.0 / math.sqrt((2 if hybrid else 1) * L)      # residual writes a layer
    specs = {"embed": ((V, d), "normal", 0.02), "final_norm": ((d,), "ones", 0)}
    if not m["tie_embeddings"]:
        specs["unembed"] = ((d, V), "normal", d ** -0.5)
    di = m["ssm_expand"] * d
    n, K = m["ssm_state"], m["ssm_conv"]
    h = di // m["ssm_head_dim"]
    conv_dim = di + 2 * n
    lay = {
        "norm1": ((L, d), "ones", 0),
        "ssm.in_proj": ((L, d, 2 * di + 2 * n + h), "normal", d ** -0.5),
        "ssm.conv_w": ((L, K, conv_dim), "normal", K ** -0.5),
        "ssm.conv_b": ((L, conv_dim), "zeros", 0),
        "ssm.A_log": ((L, h), "a_log", 0),
        "ssm.D": ((L, h), "ones", 0),
        "ssm.dt_bias": ((L, h), "dt_bias", 0),
        "ssm.gnorm": ((L, di), "ones", 0),
        "ssm.out_proj": ((L, di, d), "normal", di ** -0.5 * res),
    }
    if hybrid:
        H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
        lay.update({
            "attn.wq": ((L, d, H * hd), "normal", d ** -0.5),
            "attn.wk": ((L, d, KV * hd), "normal", d ** -0.5),
            "attn.wv": ((L, d, KV * hd), "normal", d ** -0.5),
            "attn.wo": ((L, H * hd, d), "normal", (H * hd) ** -0.5 * res),
            "norm2": ((L, d), "ones", 0),
            "mlp.wg": ((L, d, f), "normal", d ** -0.5),
            "mlp.wu": ((L, d, f), "normal", d ** -0.5),
            "mlp.wd": ((L, f, d), "normal", f ** -0.5 * res),
            "fuse_a": ((L, d), "half", 0),
            "fuse_s": ((L, d), "half", 0),
        })
    specs.update({f"layers.{k}": v for k, v in lay.items()})
    return specs


def draw_leaf(m: dict, seed: int, path: str, device) -> torch.Tensor:
    """The float32 leaf at ``path``, as :func:`draw` makes it."""
    shape, init, std = leaf_specs(m)[path]
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, path))
    if init == "normal":
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(std)
    if init == "dt_bias":
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    if init == "a_log":
        L, h = shape
        return torch.log(torch.linspace(1.0, 16.0, h, device=device)).expand(L, h).contiguous()
    value = {"ones": 1.0, "zeros": 0.0, "half": 0.5}[init]
    return torch.full(shape, value, dtype=torch.float32, device=device)


def nest(flat: dict) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flat_items(tree: dict, prefix: str = ""):
    """(path, leaf) of a nested dict, in sorted key order at every level."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from flat_items(v, path + ".")
        else:
            yield path, v


def draw(m: dict, seed: int, device) -> dict:
    """Every leaf of the model ``m``, nested as the program's parameters."""
    return nest({path: draw_leaf(m, seed, path, device) for path in leaf_specs(m)})
