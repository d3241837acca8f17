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

from torch.distributed.tensor import DTensor

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
