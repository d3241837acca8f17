"""Carry parameters, train states and decode caches between the JAX package
and the port.

Both sides meet at nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, tree)`` gives them: keys and shapes are kept
as they are, the stacked ``(L, ...)`` layer dim included.  A train state
``{"params", "opt": {"m", "v", "step"}}`` goes through the same functions:
bfloat16 moments stay bfloat16 and ``step`` stays a 0-d int32.  bfloat16 arrays
(``ml_dtypes.bfloat16``, which JAX hands out) are read through their raw
bits; going back, bfloat16 tensors widen exactly to float32, because numpy
has no bfloat16 of its own.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _array(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in tree.items()}


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else _array(v)
            for k, v in tree.items()}


def cache_from_numpy(cache, device="cuda"):
    """Decode cache from numpy arrays: ``pos`` and the stacked ``(L, ...)``
    entries, ``k``/``v`` (dense GQA), ``ckv``/``krope`` (MLA's latent) or
    ``ssm_state``/``conv_state`` (ssm)."""
    return params_from_numpy(cache, device)


def cache_to_numpy(cache):
    """Inverse of :func:`cache_from_numpy`."""
    return params_to_numpy(cache)
