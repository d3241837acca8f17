"""The system under test, built from a configuration file: the program's
``ModelConfig`` and model, with the benchmark's weights in place of the
program's own draw, and its AdamW.  The only module of the harness that
imports the program, and only when a run asks for it."""
from __future__ import annotations

import dataclasses

from bench.reference.weights import draw


def model_config(m: dict):
    from repro_torch.models.common import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in m.items() if k in fields}
    return ModelConfig(**kw)


def model(conf: dict, seed: int, device):
    """The program's model of ``conf``, whose ``init`` returns the
    benchmark's weights for ``seed`` on ``device``."""
    from repro_torch.models.registry import build
    built = build(model_config(conf["model"]))
    return built._replace(init=lambda gen=None, dev=None: draw(conf["model"], seed, device))


class HeldOptimizer:
    """The program's AdamW of ``conf["optimizer"]``, keeping the state it
    makes: the training loop keeps its state to itself, and the check
    reads the moments and weights from it."""

    def __init__(self, opt: dict):
        from repro_torch.optim.adamw import AdamW
        self.opt = AdamW(**opt)
        self.params = self.state = None

    def init(self, params):
        self.params, self.state = params, self.opt.init(params)
        return self.state

    def update(self, grads, state, params):
        return self.opt.update(grads, state, params)

    def release(self):
        self.params = self.state = None
