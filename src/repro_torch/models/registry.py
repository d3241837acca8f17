"""Uniform model interface (the fields of ``repro.models.registry.Model``)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import lm as _lm
from repro_torch.models.common import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable              # generator -> params (on the generator's device)
    forward: Callable           # (params, batch) -> (logits, aux)
    loss: Callable              # (params, batch) -> (loss, metrics)
    prefill: Callable           # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable       # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable        # (batch, max_len, device) -> cache dict


def _loss(p, b):
    raise NotImplementedError("loss_fn comes with the training slice")


def build(cfg: ModelConfig) -> Model:
    _lm.check_ported(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen: _lm.init_lm(cfg, gen),
        forward=lambda p, b: _lm.forward(cfg, p, b["tokens"], b.get("positions")),
        loss=_loss,
        prefill=lambda p, b, max_len: _lm.prefill(
            cfg, p, b["tokens"], max_len, b.get("positions")),
        decode_step=lambda p, c, t: _lm.decode_step(cfg, p, c, t),
        init_cache=lambda batch, max_len, device="cuda": _lm.init_cache(
            cfg, batch, max_len, device),
    )
