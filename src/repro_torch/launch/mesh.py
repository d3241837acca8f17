"""Device meshes: the port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the processes of
one job, one process a device, with JAX's axis names.  Each function
checks that the job's world is the mesh's size and raises otherwise, and
joins a world of one itself if the process has not joined a group; none is
called when this module is imported.  :func:`init_distributed` sets up
the job's process group first: from torchrun's environment
(``torchrun --nproc-per-node 4 -m ...``), from a ``FileStore`` path that
the tests pass, or, for a world of one, from an in-process store.

:func:`fake_world` joins a world of N ranks in one process instead, as
its rank 0, over PyTorch's ``fake`` backend: a collective there returns at
once and moves no data, so it serves for counting only (the dry run's
mesh mode, ``launch/dryrun.py``, on ``meta`` tensors), and the production
meshes are built over it with ``device_type="cpu"``.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_distributed(backend=None, *, device_type="cuda", store_path=None, rank=0,
                     world_size=1, timeout=None):
    """Join the job's default process group, once per process.

    With torchrun's ``RANK``/``WORLD_SIZE`` in the environment it reads the
    rendezvous from there (``rank`` and ``world_size`` are then ignored);
    else ``store_path`` names a ``FileStore`` that all ``world_size``
    processes share; else the world must be 1.  ``backend`` defaults to
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``; ``gloo`` on ``cuda`` puts
    several ranks on one card, which NCCL refuses (``launch/mesh_check.py``).
    ``timeout`` (a ``timedelta``) bounds each collective's wait on a peer.
    On ``cuda`` the process takes device ``LOCAL_RANK`` (else ``rank``)
    modulo the cards it sees.  Returns (rank, world size)."""
    if not dist.is_initialized():
        backend = backend or ("nccl" if device_type == "cuda" else "gloo")
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            kw = {}
        elif store_path is not None:
            kw = {"store": dist.FileStore(str(store_path), world_size), "rank": rank,
                  "world_size": world_size}
        elif world_size == 1:
            kw = {"store": dist.HashStore(), "rank": 0, "world_size": 1}
        else:
            raise ValueError(f"a world of {world_size} needs torchrun's environment or a "
                             f"store path")
        if device_type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", kw.get("rank", 0)))
            torch.cuda.set_device(local % torch.cuda.device_count())
        if timeout is not None:
            kw["timeout"] = timeout
        dist.init_process_group(backend, **kw)
    return dist.get_rank(), dist.get_world_size()


def _mesh(shape, names, device_type):
    _rank, world = init_distributed(device_type=device_type)   # a no-op once joined
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} processes, "
                         f"the job has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device_type="cuda"):
    """A small ("data", "model") mesh: the tests' four processes."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_single_mesh(*, device_type="cuda"):
    """The 1x1 ("data", "model") mesh of one process."""
    return _mesh((1, 1), ("data", "model"), device_type)


def join_fake_world(world_size: int):
    """Join a fake world of ``world_size`` ranks as rank 0 (the ``fake``
    backend over a ``FakeStore``: no other process, no data moved).
    Raises if this process already belongs to a process group, fake or
    not: it never takes over a gloo or NCCL group."""
    if dist.is_initialized():
        raise RuntimeError(f"this process already belongs to a process group "
                           f"({dist.get_backend()}, world {dist.get_world_size()}); a fake "
                           f"world is joined only by a process in none")
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def leave_world():
    """Leave the process group this process joined (``destroy_process_group``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int):
    """:func:`join_fake_world` for the block, :func:`leave_world` after."""
    join_fake_world(world_size)
    try:
        yield
    finally:
        leave_world()
