"""Assigned input-shape cells and their input specs: the port of
``repro.configs.shapes``.

LM shapes are seq_len x global_batch; decode_* / long_* run ``serve_step``
(one token against a seq_len cache), not ``train_step``.  ``long_500k``
requires sub-quadratic attention: it runs for the SSM/hybrid archs and is
SKIPPED for pure full-attention archs (recorded per cell).

Where the JAX package gives ``jax.ShapeDtypeStruct`` stand-ins, these are
tensors on the ``meta`` device: the same shapes and dtypes, no memory.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

WHISPER_ENC_LEN = 1500      # cross-attention length for whisper decode cells


def applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch: 524k-token decode requires "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""


def scale_shape(shape: Shape, *, seq: int = 0, batch: int = 0) -> Shape:
    """Reduced variant for smoke tests."""
    return Shape(shape.name, shape.kind, seq or shape.seq, batch or shape.batch)


def input_specs(cfg: ModelConfig, shape: Shape):
    """Meta-device stand-ins for every input of the step function.

    train  -> batch dict for loss/train_step
    prefill-> batch dict (+ max_len convention: cache sized to shape.seq)
    decode -> (cache dict, tokens)
    """
    B, S = shape.batch, shape.seq
    i32 = torch.int32

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if cfg.family == "encdec":
        d = cfg.d_model
        if shape.kind == "train":
            return {"frames": spec((B, S, d), cfg.cdt),
                    "dec_tokens": spec((B, max(2, S // 8)), i32)}
        if shape.kind == "prefill":
            return {"frames": spec((B, S, d), cfg.cdt),
                    "dec_tokens": spec((B, 8), i32)}
        cache = build(cfg).init_cache(B, S, device="meta", enc_len=WHISPER_ENC_LEN)
        return cache, spec((B, 1), i32)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": spec((B, S), i32)}
        if cfg.pos == "mrope":
            batch["positions"] = spec((3, B, S), i32)
        return batch
    cache = build(cfg).init_cache(B, S, device="meta")
    return cache, spec((B, 1), i32)


def concrete_inputs(cfg: ModelConfig, shape: Shape, device="cpu"):
    """Small concrete batch for smoke tests (reduced shapes only), on
    ``device``: the values JAX's ``concrete_inputs`` gives, integer leaves
    ``arange(last) % max(2, vocab - 1)`` (a 0-d one 0), float leaves 0.01."""
    def mk(s):
        if not s.dtype.is_floating_point:
            if not s.shape:
                return torch.zeros((), dtype=s.dtype, device=device)
            row = torch.arange(s.shape[-1], dtype=s.dtype, device=device) % max(2, cfg.vocab - 1)
            return row.expand(s.shape).clone()
        return torch.full(s.shape, 0.01, dtype=s.dtype, device=device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(tree(v) for v in x)
        return mk(x)

    return tree(input_specs(cfg, shape))
