"""The benchmark's weights: drawn from ``--seed`` on the device, one call a
leaf, in float32, in the layout of the served and trained program (the
layers stacked ``(L, ...)``; each family's ``leaf_specs``), and handed
alike to the program and to the reference.

Each leaf has a generator of its own, seeded from (seed, the leaf's path),
so one leaf can be drawn again without the others: the reference redraws
the initial weights leaf by leaf to measure how far training moved them.
"""
from __future__ import annotations

import hashlib
import math

import torch

from bench import families


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for the leaf at ``path`` of run ``seed``."""
    digest = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(m: dict) -> dict:
    """{path: (shape, init, std)} of the model ``m`` (a configuration
    file's ``model``), from its family's module (``bench/families/``):
    init is one of :data:`INITS` or of the family's own ``INITS``.

    The families draw with the published initializations (Mamba-2's
    ``mamba_ssm``, GPT-2's): the embedding N(0, 0.02^2), each projection
    N(0, 1/fan_in), the projections that write into the residual stream
    scaled by 1/sqrt(writes a layer x layers)."""
    return families.of(m).leaf_specs(m)


def lm_specs(m: dict, layer: dict) -> dict:
    """The specs of a decoder LM whose stacked layers hold ``layer``
    ({path: spec}, shapes with the leading ``L``): the embedding
    N(0, 0.02^2), the final norm, and an untied unembedding
    N(0, 1/d)."""
    d, V = m["d_model"], m["vocab"]
    specs = {"embed": ((V, d), "normal", 0.02), "final_norm": ((d,), "ones", 0)}
    if not m["tie_embeddings"]:
        specs["unembed"] = ((d, V), "normal", d ** -0.5)
    specs.update({f"layers.{k}": v for k, v in layer.items()})
    return specs


def _normal(shape, std, gen, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std)


def _dt_bias(shape, std, gen, device):
    """softplus^-1 of a step drawn log-uniform in [1e-3, 1e-1]."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return dt + torch.log(-torch.expm1(-dt))


def _a_log(shape, std, gen, device):
    """log of 1..16 spread over the SSM heads, the same in every layer."""
    L, h = shape
    return torch.log(torch.linspace(1.0, 16.0, h, device=device)).expand(L, h).contiguous()


def _full(value):
    return lambda shape, std, gen, device: torch.full(shape, value, dtype=torch.float32,
                                                      device=device)


# the init kinds every family may use: fn(shape, std, gen, device)
INITS = {"normal": _normal, "dt_bias": _dt_bias, "a_log": _a_log,
         "ones": _full(1.0), "zeros": _full(0.0), "half": _full(0.5)}


def draw_leaf(m: dict, seed: int, path: str, device) -> torch.Tensor:
    """The float32 leaf at ``path``, as :func:`draw` makes it."""
    family = families.of(m)
    shape, init, std = family.leaf_specs(m)[path]
    gen = torch.Generator(device).manual_seed(leaf_seed(seed, path))
    return {**INITS, **getattr(family, "INITS", {})}[init](shape, std, gen, device)


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
