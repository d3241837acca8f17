"""LR schedules (as multiplicative factors on the base lr): the port of
``repro.optim.schedules``, in float32 on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    def f(step):
        step = torch.as_tensor(step).float()
        warm = step / max(1.0, float(warmup))
        prog = (step - warmup) / max(1.0, float(total - warmup))
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog.clamp(0, 1)))
        return torch.where(step < warmup, warm, cos)
    return f


def constant():
    return lambda step: 1.0
