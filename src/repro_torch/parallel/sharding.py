"""Partition rules: DP / FSDP / TP / EP over a device mesh, the port of
``repro.parallel.sharding``.

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
on two.  The policy is the JAX package's (MaxText-style fsdp + tensor):

  * batch dims -> ("pod", "data") (DP across pods);
  * attention heads / ffn / vocab -> "model" (TP);
  * the MoE expert dim -> "model" (EP);
  * the largest remaining weight dim -> "data" (FSDP; the optimizer's
    moments follow the parameters' specs);
  * pods never shard parameters.

Every choice is checked against the mesh: a dim that an axis does not
divide stays unsharded.  A spec is kept in JAX's form, one entry per
tensor dim (an axis name, a tuple of them, or None; ``()`` for a leaf
that is replicated), so that the tests compare it with the JAX package's
entry for entry.  :func:`placements` turns one into DTensor placements,
one per mesh dim, and :func:`distribute` places a tree.  The parameter
trees are nested dicts: a leaf's name is its last key, and it is an
expert's weight when a ``"moe"`` key lies on its path.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

FSDP = "__fsdp__"    # placeholder resolved to "data" when fsdp is on

# spec for the trailing dims of each named leaf (leading dims -> None)
_RULES = {
    # dense attention
    "wq": (FSDP, "model"), "wk": (FSDP, "model"), "wv": (FSDP, "model"),
    "wo": ("model", FSDP),
    # mlp (swiglu)
    "wg": (FSDP, "model"), "wu": (FSDP, "model"), "wd": ("model", FSDP),
    # whisper mlp / biases
    "w1": (FSDP, "model"), "b1": ("model",), "w2": ("model", FSDP), "b2": (None,),
    # MLA
    "wq_a": (FSDP, "model"), "wq_b": (FSDP, "model"),
    "wkv_a": (FSDP, None), "wkv_b": (FSDP, "model"),
    # MoE (rank>=3 leaves resolved by _MOE_RULES)
    "router": (FSDP, None),
    # SSM (activations replicated over model; weights FSDP only)
    "in_proj": (FSDP, None), "out_proj": (FSDP, None),
    "conv_w": (None, None), "conv_b": (None,),
    # embeddings
    "embed": ("model", FSDP), "unembed": (FSDP, "model"),
    "pos_table": (FSDP, None), "dec_pos": (FSDP, None),
}

_MOE_RULES = {   # (E, d, f) / (E, f, d)
    "wg": ("model", FSDP, None), "wu": ("model", FSDP, None),
    "wd": ("model", None, FSDP),
}


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fits(dim: int, axis, sizes) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            total *= sizes.get(a, 1)
        return dim % total == 0
    return dim % sizes.get(axis, 1) == 0


def _resolve(tail_spec, shape, sizes, fsdp):
    """Right-align ``tail_spec`` onto ``shape``; divisibility-checked."""
    spec = [None] * len(shape)
    off = len(shape) - len(tail_spec)
    if off < 0:
        tail_spec = tail_spec[-len(shape):]
        off = 0
    for i, ax in enumerate(tail_spec):
        if ax == FSDP:
            ax = "data" if fsdp else None
        if ax is not None and _fits(shape[off + i], ax, sizes):
            spec[off + i] = ax
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    return {k: _map_with_path(fn, v, (*path, k)) if isinstance(v, dict) else fn((*path, k), v)
            for k, v in tree.items()}


def param_specs(params, mesh, *, fsdp: bool = True):
    """A spec tree mirroring ``params`` (tensors or anything with a shape)."""
    sizes = mesh_sizes(mesh)

    def rule(path, leaf):
        name = path[-1]
        if "moe" in path and name in _MOE_RULES and len(leaf.shape) >= 3:
            return _resolve(_MOE_RULES[name], leaf.shape, sizes, fsdp)
        if name in _RULES:
            return _resolve(_RULES[name], leaf.shape, sizes, fsdp)
        return ()      # norms, scalars, gates: replicated

    return _map_with_path(rule, params)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def spec_entry(axes):
    """A spec entry as JAX's ``PartitionSpec`` holds it: a tuple of one
    axis is that axis' name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def batch_specs(batch, mesh):
    """Shard the leading batch dim over the DP axes.  For M-RoPE positions
    (3, B, S) the batch dim is axis 1."""
    dp = dp_axes(mesh)
    sizes = mesh_sizes(mesh)

    def rule(path, leaf):
        ndim = len(leaf.shape)
        bdim = 1 if path[-1] == "positions" and ndim == 3 else 0
        spec = [None] * ndim
        if _fits(leaf.shape[bdim], dp, sizes):
            spec[bdim] = spec_entry(dp)
        return tuple(spec)

    return _map_with_path(rule, batch)


def cache_specs(cache, mesh):
    """Decode caches: batch over DP; kv heads over model when divisible,
    else the sequence.  Layout (stacked over layers): k/v (L,B,S,KV,hd),
    ckv/krope (L,B,S,r), ssm_state (L,B,h,P,n), conv_state (L,B,K,c), pos
    a scalar."""
    dp = dp_axes(mesh)
    sizes = mesh_sizes(mesh)

    def rule(path, leaf):
        name, ndim = path[-1], len(leaf.shape)
        if ndim == 0 or name == "pos":
            return ()
        spec = [None] * ndim
        if ndim >= 2 and _fits(leaf.shape[1], dp, sizes):
            spec[1] = spec_entry(dp)
        if name in ("k", "v", "ek", "ev") and ndim == 5:
            if _fits(leaf.shape[3], "model", sizes):
                spec[3] = "model"            # TP over KV heads
            elif _fits(leaf.shape[2], "model", sizes):
                spec[2] = "model"            # context-parallel cache (MQA/GQA<16)
        elif name in ("ckv", "krope") and ndim == 4 and _fits(leaf.shape[2], "model", sizes):
            spec[2] = "model"                # MLA latent cache: shard sequence
        return tuple(spec)

    return _map_with_path(rule, cache)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` where
    tensor dim d names that mesh axis (alone or in a tuple: a tuple such as
    ("pod", "data") shards d over both, in mesh order), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def spec_of(placements_, mesh, ndim: int) -> tuple:
    """The spec of ``placements_`` (the inverse of :func:`placements`): per
    tensor dim, the mesh axis that shards it, a tuple of several, or None."""
    axes = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements_):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


def distribute(tree, mesh, specs, *, src_data_rank=0):
    """``tree``'s tensors as DTensors, each placed by its leaf of ``specs``:
    a spec, or the DTensor placements themselves (as ``train.steps``'
    sharding trees hold them).  Each rank keeps its own shard: of rank
    ``src_data_rank``'s tensors (scattered from it), or, with
    ``src_data_rank=None``, of its own, which every rank must then hold
    alike (drawn from the same seed)."""
    def place(t, spec):
        pl = spec if spec and all(isinstance(e, Placement) for e in spec) \
            else placements(spec, mesh)
        return distribute_tensor(t, mesh, pl, src_data_rank=src_data_rank)

    return {k: distribute(v, mesh, specs[k], src_data_rank=src_data_rank)
            if isinstance(v, dict) else place(v, specs[k]) for k, v in tree.items()}


def full(tree):
    """Each DTensor of ``tree`` gathered whole on every rank (a collective:
    every rank calls it); other leaves as they are."""
    return {k: full(v) if isinstance(v, dict)
            else v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in tree.items()}
