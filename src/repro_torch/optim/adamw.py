"""AdamW with global-norm clipping and configurable moment dtype: the port
of ``repro.optim.adamw``, with the same arithmetic in float32.

The JAX version returns new parameters and moments and the train step
donates the old ones; here ``update`` writes them in place, which is what
donation buys: no second copy of the parameters or the moments."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def tree_leaves(tree):
    """The leaves of a nested dict, in sorted key order at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Optional[str] = None   # None: match param dtype
    schedule: Optional[object] = None    # callable step -> lr scale

    def _mdt(self, leaf):
        return getattr(torch, self.moment_dtype) if self.moment_dtype else leaf.dtype

    def init(self, params):
        """{"m", "v"}: zeros shaped as ``params``; "step": an int32 scalar
        tensor, as in the JAX state, so that checkpoints carry across."""
        def zeros(tree):
            return {k: zeros(v) if isinstance(v, dict)
                    else torch.zeros(v.shape, dtype=self._mdt(v), device=v.device)
                    for k, v in tree.items()}
        dev = next(tree_leaves(params)).device
        return {"m": zeros(params), "v": zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step, in place: ``params``, ``state["m"]``, ``state["v"]``
        and ``state["step"]`` are overwritten.  ``grads`` is a dict shaped as
        ``params``.  Returns the metrics ``{"grad_norm"}``."""
        step = state["step"] + 1
        gs = list(tree_leaves(grads))
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
            gs = [g * scale.to(g.dtype) for g in gs]
        else:
            gn = torch.zeros((), dtype=torch.float32, device=step.device)
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
        lr = self.lr * (self.schedule(step) if self.schedule else 1.0)
        for g, m, v, p in zip(gs, tree_leaves(state["m"]), tree_leaves(state["v"]),
                              tree_leaves(params)):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            mh = m_new / c1
            vh = v_new / c2
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.float()
            p.add_((-lr * delta).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        state["step"].copy_(step)
        return {"grad_norm": gn}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
