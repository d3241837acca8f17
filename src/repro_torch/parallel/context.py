"""The mesh in scope, and sharding constraints against it: the port of
``repro.parallel.context``.

Model code is mesh-agnostic: its parameters and batches come in as
DTensors (``parallel/sharding.py``), and PyTorch's DTensor dispatch plays
the part of JAX's pjit auto-sharding.  The step builders set the mesh
around a step (``train.steps.bind_mesh``); the expert-parallel MoE path
reads it, and :func:`constrain` pins an activation to the placements JAX
pins it to.  With no mesh set, models take their one-device paths.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel.sharding import mesh_sizes, placements, spec_entry

_LOCAL = threading.local()


def current_mesh():
    return getattr(_LOCAL, "mesh", None)


@contextlib.contextmanager
def with_mesh(mesh):
    prev = current_mesh()
    _LOCAL.mesh = mesh
    try:
        yield
    finally:
        _LOCAL.mesh = prev


def model_size(mesh: Optional[object] = None) -> int:
    """The size of the ``model`` axis of ``mesh`` (default: the one in
    scope); 1 without a mesh or without that axis."""
    mesh = current_mesh() if mesh is None else mesh
    return 1 if mesh is None else mesh_sizes(mesh).get("model", 1)


def constrain_spec(shape, axes, mesh) -> tuple:
    """JAX's per-dim choice: ``axes`` names a mesh axis, a tuple of them or
    None per dim; ``"__dp__"`` is every axis but ``model``; a dim that the
    axes' size does not divide, and every dim past ``axes``, stays
    unsharded."""
    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    spec = []
    for dim, ax in zip(shape, axes):
        if ax == "__dp__":
            ax = tuple(a for a in names if a != "model")
        if isinstance(ax, tuple):
            total = 1
            for a in ax:
                total *= sizes.get(a, 1)
            spec.append(spec_entry(ax) if total > 0 and dim % total == 0 else None)
        elif ax is not None and ax in sizes and dim % sizes[ax] == 0:
            spec.append(ax)
        else:
            spec.append(None)
    return tuple(spec + [None] * (len(shape) - len(spec)))


def constrain(x, axes):
    """``x`` redistributed to :func:`constrain_spec`'s placements on the
    mesh in scope; the identity with no mesh in scope or for a plain
    tensor."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(constrain_spec(x.shape, axes, mesh), mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def split_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (a reshape).  GSPMD
    tiles a sharded dim over the pieces it splits into; DTensor shards
    only the first piece, and refuses when the axis that shards the dim
    does not divide it (8 kv heads on a 16-wide ``model`` axis).  There
    that axis is gathered first, as replicated, and the later
    :func:`constrain` at the kernel's site shards the heads again."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        sizes_ = mesh_sizes(x.device_mesh)
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                   and sizes[0] % sizes_[name] else p
                   for name, p in zip(x.device_mesh.mesh_dim_names, x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


class _MergeLast(torch.autograd.Function):
    """The last two dims flattened; the backward splits the gradient with
    :func:`split_last`, where a view's backward would refuse a gradient
    that the product after it left sharded on the flat dim."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, grad):
        return split_last(grad, *ctx.sizes)


def merge_last(x):
    """``x`` with its last two dims flattened into one (a reshape); on a
    DTensor its gradient goes back through :func:`split_last`."""
    if isinstance(x, DTensor):
        return _MergeLast.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements, a partial sum there
    taken as replicated (a partial placement is DTensor's own to make);
    the identity for plain tensors."""
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in ref.placements)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)
