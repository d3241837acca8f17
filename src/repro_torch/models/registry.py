"""Uniform model interface (the fields of ``repro.models.registry.Model``)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import encdec as _encdec
from repro_torch.models import lm as _lm
from repro_torch.models.common import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable              # generator -> params (on the generator's device)
    forward: Callable           # (params, batch) -> (logits, aux)
    loss: Callable              # (params, batch) -> (loss, metrics)
    prefill: Callable           # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable       # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable        # (batch, max_len, device[, enc_len]) -> cache dict


def build(cfg: ModelConfig) -> Model:
    """The model of ``cfg``'s family.  Its batches are {tokens (B, S)[,
    positions]}, or for the encoder-decoder {frames (B, S_enc, d),
    dec_tokens (B, S)}."""
    _lm.check_ported(cfg)
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: _encdec.init_encdec(cfg, gen),
            forward=lambda p, b: _encdec.forward(cfg, p, b["frames"], b["dec_tokens"]),
            loss=lambda p, b: _encdec.loss_fn(cfg, p, b),
            prefill=lambda p, b, max_len: _encdec.prefill(
                cfg, p, b["frames"], b["dec_tokens"], max_len),
            decode_step=lambda p, c, t: _encdec.decode_step(cfg, p, c, t),
            init_cache=lambda batch, max_len, device="cuda", enc_len=_encdec.ENC_LEN:
                _encdec.init_cache(cfg, batch, max_len, enc_len, device),
        )
    return Model(
        cfg=cfg,
        init=lambda gen: _lm.init_lm(cfg, gen),
        forward=lambda p, b: _lm.forward(cfg, p, b["tokens"], b.get("positions")),
        loss=lambda p, b: _lm.loss_fn(cfg, p, b),
        prefill=lambda p, b, max_len: _lm.prefill(
            cfg, p, b["tokens"], max_len, b.get("positions")),
        decode_step=lambda p, c, t: _lm.decode_step(cfg, p, c, t),
        init_cache=lambda batch, max_len, device="cuda": _lm.init_cache(
            cfg, batch, max_len, device),
    )
