"""Step builders: the port of ``repro.train.steps`` on one device.

The train step takes the loss's gradient with autograd (attention through
the backward kernel on the card), optionally int8-compresses every gradient
leaf (K2 on the card), and applies AdamW in place.  The sharding builders
come with the distribution slice."""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW, tree_leaves


def init_train_state(model: Model, optimizer: AdamW, gen: torch.Generator):
    """{"params", "opt"} on ``gen.device``, parameters drawn from ``gen``."""
    params = model.init(gen)
    return {"params": params, "opt": optimizer.init(params)}


def _unflatten_like(tree, it):
    return {k: _unflatten_like(v, it) if isinstance(v, dict) else next(it)
            for k, v in sorted(tree.items())}


def make_train_step(model: Model, optimizer: AdamW, *, compress: bool = False):
    """``step(state, batch) -> metrics``: one optimizer step that updates
    ``state`` in place (the counterpart of the JAX step's donated state).
    ``batch``: the model's batch on the state's device, {"tokens": (B, S)
    int} or, for the encoder-decoder, {"frames", "dec_tokens"}.  The
    metrics ("loss", "ce", "aux", "grad_norm") are 0-d tensors."""
    def step(state, batch):
        params = state["params"]
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _unflatten_like(params, iter(grads))
        if compress:
            grads = grad_compress.compress_tree(grads)
        om = optimizer.update(grads, state["opt"], params)
        return {**{k: v.detach() for k, v in metrics.items()}, "loss": loss.detach(), **om}

    return step

