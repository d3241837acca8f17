"""Pipeline parallelism: the GPipe schedule over a mesh axis, the port of
``repro.parallel.pipeline`` (the rotating-buffer formulation).

Layers are split into ``n_stages`` contiguous groups; stage s holds its
group's parameters (leading dim sharded over the stage axis).  Microbatches
enter at stage 0, activations move from stage s to s + 1 each tick, and
outputs drain from the last stage into stage 0.  Where JAX shifts with
``ppermute`` inside ``shard_map``, each rank here runs the schedule on its
own shard (``local_map``) and shifts with an all-to-all in which it sends
to one rank only (``all_to_all_single_autograd``): the shift's backward is
the reverse shift, so autograd through :func:`pipeline_apply` runs the
reverse schedule, as ``jax.grad`` does.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map
from torch.utils import _pytree as pytree

from repro_torch.parallel.sharding import mesh_sizes


def pipeline_apply(mesh, axis: str, stage_fn, stage_params, microbatches):
    """Run ``microbatches`` (M, mb, ...) through the ``n`` stages of
    ``stage_fn(params_slice, x) -> y`` (y shaped as x) over the mesh axis
    ``axis`` of size n.

    ``stage_params``: a pytree whose leaves have leading dim n, as DTensors
    sharded on it over ``axis`` or as plain tensors alike on every rank (each
    rank then keeps its stage's slice).  ``microbatches``: a plain tensor
    alike on every rank, or a replicated DTensor.  Returns the (M, mb, ...)
    outputs, a DTensor replicated on every rank: M + n - 1 ticks, then a sum
    over the axis, where only stage 0 holds outputs."""
    n = mesh_sizes(mesh)[axis]
    dim = mesh.mesh_dim_names.index(axis)
    M = microbatches.shape[0]
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    on_axis = tuple(Shard(0) if i == dim else Replicate() for i in range(mesh.ndim))
    summed = tuple(Partial() if i == dim else Replicate() for i in range(mesh.ndim))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    send = [0] * n
    recv = [0] * n

    def shift(y):
        """y to stage + 1 (the last stage's to stage 0); the previous
        stage's y back."""
        numel = y.numel()
        send[(stage + 1) % n] = recv[(stage - 1) % n] = numel
        out = funcol.all_to_all_single_autograd(y.reshape(numel), list(recv), list(send),
                                                group)
        return out.reshape(y.shape)

    def local(params, mbs):
        params = pytree.tree_map(lambda a: a[0], params)
        # selected as JAX selects (``where``), not branched on: every rank's
        # graph then holds every shift, so that each rank runs every reverse
        # shift of the backward in the same order
        first = torch.tensor(stage == 0, device=mbs.device)
        buf = torch.zeros_like(mbs[0])
        outs = [torch.zeros_like(mbs[0])] * M
        for t in range(M + n - 1):
            x_in = torch.where(first, mbs[t] if t < M else torch.zeros_like(buf), buf)
            buf = shift(stage_fn(params, x_in))
            # after the shift, stage 0 holds what the last stage produced at
            # tick t: microbatch t - (n - 1), through every stage
            if t >= n - 1:
                outs[t - (n - 1)] = torch.where(first, buf, outs[t - (n - 1)])
        return torch.stack(outs)

    params = pytree.tree_map(
        lambda a: a if isinstance(a, DTensor)
        else distribute_tensor(a, mesh, on_axis, src_data_rank=None), stage_params)
    if not isinstance(microbatches, DTensor):
        microbatches = DTensor.from_local(microbatches, mesh, rep, run_check=False)
    n_leaves = len(pytree.tree_leaves(params))
    # only stage 0 reads the microbatches, so their gradient is a sum over the axis
    out = local_map(local, out_placements=(summed,),
                    in_placements=(on_axis,) * n_leaves + (rep,),
                    in_grad_placements=(on_axis,) * n_leaves + (summed,),
                    device_mesh=mesh)(params, microbatches)
    return out.redistribute(mesh, rep)


def split_stages(stacked_layer_params, n_stages: int):
    """Reshape scan-stacked layer params (L, ...) -> (n_stages, L/n_stages, ...)."""
    def r(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return pytree.tree_map(r, stacked_layer_params)
