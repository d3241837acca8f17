"""The dry run: the port of ``repro.launch.dryrun``, for every (arch x
shape) cell, at 1x1 (``make_single_mesh``) and on the JAX dry run's
production meshes, 16x16 (``single``) and 2x16x16 (``multi``).

    python -m repro_torch.launch.dryrun --all --device cpu
    python -m repro_torch.launch.dryrun --all --mesh both --device cpu [--no-fsdp]
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --batch 32

Each cell's step (``train_step``, ``prefill_step`` or ``serve_step`` of
``train/steps.py``, on the inputs of ``configs/shapes.py``) runs once on
``meta`` tensors: shapes and dtypes only, no memory, no data.  That run
gives the bytes of the state (parameters, and for a train cell the AdamW
moments, bf16 where the parameters are, as the JAX dry run sets them),
the inputs, the cache and the outputs, their sum ``resident_bytes``
(activations and temporaries not counted), whether that fits the card's
80 GB, and what :class:`LocalCount` counts of the run.

On a production mesh (``--mesh single|multi|both``) the process joins a
fake world of 256 or 512 ranks (``launch/mesh.py``: the fake backend moves
no data), places the abstract state, inputs and cache as DTensors of
``meta`` shards by ``train_shardings`` (FSDP on unless ``--no-fsdp``) or
``serve_shardings`` (each rank's own shard, no collective) and runs the
step under ``bind_mesh``, as the 1x1 mode runs it.  Everything is counted
on rank 0's shards, which are the largest of an uneven split: the record
is per device, as the JAX dry run's are, with the collectives DTensor and
the model run.  The mesh mode runs on meta only (JAX forces a host
platform for it); with ``--device cuda`` it raises.

The counts (:class:`LocalCount`, on each op a device runs):

  * ``flops``: the products ``torch.utils.flop_counter``'s registry
    counts, with attention and the SSD scan as their plain versions
    compute them on meta (``kernels/ops.py``): every (query, key) score,
    the causal half included, and every chunk's quadratic block;
    ``flops_by_dtype`` and ``flops_by_op`` split it;
  * ``hbm_bytes``: twice the bytes of every result an op materialises
    (written once, read about once: ``benchmarks/hlo_analysis.py``'s
    convention; views, ``empty`` and metadata ops skipped; an indexed
    in-place write counts what it writes).  In eager mode every op's
    result is materialised, so this is the port's own traffic;
  * ``work_flops``, ``work_flops_by_dtype``, ``work_hbm_bytes``: the
    same with the three kernels as units.  While ``ops.flash_attention``,
    ``ops.ssd`` or ``ops.quantize`` runs its plain version, its ops add
    nothing to them; each call adds its kernel's own work instead
    (``launch/roofline.py``: K1's and its backward's operations over the
    visible pairs and the bytes of q, k, v, o, K3's and its backward's, and
    K2's), on the shapes of the rank's shard;
  * ``collectives``: by kind (``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``, and an all-to-all to one peer as
    ``collective_permute``), ``_count``, ``_operand`` and ``_wire`` bytes
    (``hlo_analysis.py``'s ring factors), summed into ``wire_bytes``;
    ``groups`` gives each mesh axis' ranks (rank 0's group) and wire
    bytes, which ``launch/roofline.py`` sets against its link;
  * ``k1_flops``: K1's operations alone, forward and backward.

With ``--device cuda`` (1x1) the cell also runs on the card, once per
``--reps`` (each step timed on the host clock around synchronised work),
at the ``--batch`` cut or, without one, at the full batch when it fits the
card; the record then has ``peak_bytes`` (``torch.cuda.max_memory_allocated``),
each step's ms, the hand-written kernels' launches and the cut's own
counts (``card["count"]``, which ``launch/roofline.py`` reads), and with
``--profile`` one more step's device time by kernel and busy share.  One
JSON record a cell goes to ``--out`` (default ``build/dryrun``), tagged
``{arch}__{shape}__{1x1|single|multi}``; :func:`run_cell` returns it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._guards import detect_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import all_archs, get_config
from repro_torch.configs.shapes import (SHAPES, applicable, concrete_inputs, input_specs,
                                        scale_shape)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import roofline
from repro_torch.launch.roofline import k1_call_flops
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as shd
from repro_torch.train import steps as tsteps

CARD_BYTES = 80 * 10**9          # one H100's 80 GB
TOP = 10                         # kernels a profiled card run lists
MESHES = {"single": 256, "multi": 512}   # the production meshes' ranks
FLOPS_NOTE = ("torch.utils.flop_counter's registry over the meta run: attention and the SSD "
              "scan are counted as their plain versions compute them, every (query, key) "
              "score (the causal half included) and every chunk's quadratic block")
WORK_NOTE = ("the kernels as units: K1 and K3 (and their backwards) and K2 each add their own "
             "operations and bytes (launch/roofline.py) in place of their plain versions' ops")


def optimizer_for(cfg) -> AdamW:
    """The JAX dry run's optimizer: bf16 moments where the parameters are bf16."""
    return AdamW(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)


def nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict / tuple / list; of a DTensor,
    this rank's shard."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


# ---------------------------------------------------------------- counting

# ops that ask for sizes and strides (FlopCounterMode passes them on too)
_META_OPS = {torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
             torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
             torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
             torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
             torch.ops.prim.layout.default}
# results that are not written: fresh allocations, aliases of a result counted already
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "_unsafe_view", "lift_fresh", "_local_scalar_dense", "set_",
             "resize_"}
# in-place writes that touch only the rows their source holds
_INDEXED = {"index_put_", "index_copy_", "index_add_", "scatter_", "scatter_add_",
            "masked_scatter_", "_index_put_impl_"}
_COLLECTIVES = {"all_reduce": "all_reduce", "all_reduce_": "all_reduce",
                "allreduce_": "all_reduce", "all_gather_into_tensor": "all_gather",
                "_allgather_base_": "all_gather", "allgather_": "all_gather",
                "all_gather_into_tensor_out": "all_gather",
                "reduce_scatter_tensor": "reduce_scatter",
                "_reduce_scatter_base_": "reduce_scatter", "reduce_scatter_": "reduce_scatter",
                "all_to_all_single": "all_to_all", "alltoall_base_": "all_to_all",
                "broadcast": "broadcast", "broadcast_": "broadcast"}
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "collective_permute",
         "broadcast")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _size(t) -> int:
    return t.numel() * t.element_size()


class LocalCount(TorchDispatchMode):
    """Counts the ops one device runs: FLOPs by ``flop_registry`` on the
    ops' own shapes, the bytes of their results and the collectives, in
    a plain tally and in a ``work`` tally with the kernels as units
    (:meth:`unit`, :meth:`inside`).

    On a DTensor op it returns ``NotImplemented``, as
    ``torch.distributed.tensor.debug.CommDebugMode`` does: DTensor then
    runs and this mode sees the local ops it runs on the rank's shards
    (and the collectives of its redistributes), not the op at global
    shapes.  DTensor's shape propagation (ops on fake tensors) is skipped.
    ``groups`` maps a process group's name to its mesh axis and ranks."""

    def __init__(self, groups=None):
        super().__init__()
        self.groups = groups or {}
        self.flops = 0
        self.flops_by_dtype = collections.Counter()
        self.flops_by_op = collections.Counter()
        self.work_flops_by_dtype = collections.Counter()
        self.hbm_bytes = 0
        self.work_hbm_bytes = 0
        self.collectives = collections.Counter()
        self.group_wire = collections.Counter()
        self._inside = 0          # > 0: in a unit's plain version (plain tally only)
        self._muted = 0           # > 0: counted nowhere (a unit's recompute)

    # -- units
    def unit(self, dtype, flops, nbytes):
        """A kernel's own work, into the work tally."""
        self.work_flops_by_dtype[str(dtype).removeprefix("torch.")] += int(flops)
        self.work_hbm_bytes += int(nbytes)

    @contextlib.contextmanager
    def inside(self, *, muted=False):
        """Ops run here count in the plain tally only (or, ``muted``, in
        neither)."""
        attr = "_muted" if muted else "_inside"
        setattr(self, attr, getattr(self, attr) + 1)
        try:
            yield
        finally:
            setattr(self, attr, getattr(self, attr) - 1)

    # -- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _META_OPS:
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            with self:                                # a composite op: count its parts
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._muted or detect_fake_mode(args) is not None:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._opname
        flop = flop_registry.get(func._overloadpacket)
        work = not self._inside
        if flop is not None:
            n = int(flop(*args, **kwargs, out_val=out))
            first = next(_tensors(args), None)
            dt = str(first.dtype).removeprefix("torch.") if first is not None else "float32"
            self.flops += n
            self.flops_by_dtype[dt] += n
            self.flops_by_op[str(func._overloadpacket)] += n
            if work:
                self.work_flops_by_dtype[dt] += n
        if func.namespace in ("_c10d_functional", "_c10d_functional_autograd", "c10d") \
                and name in _COLLECTIVES:
            written = self._collective(_COLLECTIVES[name], func, args, out)
        elif func.is_view or name in _NO_BYTES or func.namespace in ("_c10d_functional", "c10d"):
            return
        elif name in _INDEXED:
            written = sum(_size(t) for t in _tensors(args[2:]))
        else:
            written = sum(_size(t) for t in _tensors(out))
        self.hbm_bytes += 2 * written
        if work:
            self.work_hbm_bytes += 2 * written

    def _collective(self, kind, func, args, out) -> int:
        """Record one collective; returns the bytes of its result."""
        if func.namespace == "c10d":          # (output(s), input(s), group, ...)
            tensors = [a for a in args if isinstance(a, (torch.Tensor, list))]
            outs = list(_tensors(tensors[0]))
            ins = list(_tensors(tensors[1])) if len(tensors) > 1 else outs
            group = next(a for a in args if isinstance(a, (torch.ScriptObject, dist.ProcessGroup)))
            splits = [args[3], args[4]] if kind == "all_to_all" else None
        else:
            ins, outs = list(_tensors(args[0])), list(_tensors(out))
            group = args[-1]
            splits = [args[1], args[2]] if kind == "all_to_all" else None
        if isinstance(group, torch.ScriptObject):     # a c10d op's boxed group
            group = dist.ProcessGroup.unbox(group)
        name = group if isinstance(group, str) else group.group_name
        operand, result = sum(_size(t) for t in ins), sum(_size(t) for t in outs)
        if kind == "all_to_all" and splits[1] and sum(1 for n in splits[1] if n) == 1:
            kind = "collective_permute"       # the whole input to one peer
        wire = {"all_reduce": 2 * operand, "all_gather": max(result - operand, operand),
                "reduce_scatter": operand, "all_to_all": operand,
                "collective_permute": operand, "broadcast": operand}[kind]
        self.collectives[kind + "_count"] += 1
        self.collectives[kind + "_operand"] += operand
        self.collectives[kind + "_wire"] += wire
        self.group_wire[self.groups.get(name, {}).get("axis", name)] += wire
        return result

    def plain_tally(self):
        """A copy of the plain tally (what a unit's plain version adds)."""
        return (self.flops, collections.Counter(self.flops_by_dtype),
                collections.Counter(self.flops_by_op), self.hbm_bytes)

    def add_plain(self, delta):
        """Add a difference of two :meth:`plain_tally` readings."""
        self.flops += delta[0]
        self.flops_by_dtype.update(delta[1])
        self.flops_by_op.update(delta[2])
        self.hbm_bytes += delta[3]

    def record(self) -> dict:
        """The tallies as record fields."""
        groups = {g["axis"]: {"size": len(g["ranks"]), "ranks": g["ranks"],
                              "wire_bytes": int(self.group_wire.get(g["axis"], 0))}
                  for g in self.groups.values()}
        for axis, wire in self.group_wire.items():   # a group outside the mesh's axes
            groups.setdefault(axis, {"size": 0, "ranks": [], "wire_bytes": int(wire)})
        return {"flops": int(self.flops), "flops_note": FLOPS_NOTE,
                "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
                "flops_by_op": dict(sorted(self.flops_by_op.items())),
                "hbm_bytes": int(self.hbm_bytes),
                "work_flops": int(sum(self.work_flops_by_dtype.values())),
                "work_flops_by_dtype": dict(sorted(self.work_flops_by_dtype.items())),
                "work_hbm_bytes": int(self.work_hbm_bytes), "work_note": WORK_NOTE,
                "collectives": {k: int(v) for k, v in sorted(self.collectives.items())},
                "wire_bytes": int(sum(v for k, v in self.collectives.items()
                                      if k.endswith("_wire"))),
                "groups": groups}


def mesh_groups(mesh) -> dict:
    """{group name: {"axis", "ranks"}} of each axis of ``mesh`` (rank 0's
    group on it)."""
    if mesh is None:
        return {}
    out = {}
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        out[group.group_name] = {"axis": axis, "ranks": dist.get_process_group_ranks(group)}
    return out


class _PlainUnit(torch.autograd.Function):
    """A unit's plain version as one autograd node, so that its backward
    (K1's, K3's) is a unit too: the forward runs ``fn`` inside the unit;
    the backward adds ``bwd_work(douts)`` (the outputs' gradients, None for
    an unused output) and differentiates ``fn`` again, its recompute
    counted nowhere and its gradient ops in the plain tally only, which
    then holds the same ops as autograd through ``fn``.  The backward runs
    through ``plain(fn, *tensors)`` (``units``' memo on meta); the forward
    always runs ``fn``, since a remat region replays its forward's ops in
    the recompute and checks them."""

    @staticmethod
    def forward(ctx, fn, count, bwd_work, plain, *inputs):
        ctx.fn, ctx.count, ctx.bwd_work, ctx.plain = fn, count, bwd_work, plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        with count.inside():
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *douts):
        inputs = ctx.saved_tensors
        ctx.count.unit(*ctx.bwd_work(douts))
        wanted = [t.requires_grad for t in inputs]
        used = tuple(d is not None for d in douts)

        def grads(*tensors):
            xs = [t.detach().requires_grad_(w) for t, w in zip(tensors, wanted)]
            with torch.enable_grad():
                with ctx.count.inside(muted=True):
                    out = ctx.fn(*xs)
                outs = [o for o, u in zip(out if isinstance(out, tuple) else (out,), used) if u]
                return torch.autograd.grad(outs, [x for x in xs if x.requires_grad],
                                           tensors[len(xs):], allow_unused=True)

        got = ctx.plain(used, grads, *inputs, *(d for d in douts if d is not None))
        got = iter(got if isinstance(got, tuple) else (got,))
        return (None, None, None, None, *(next(got) if w else None for w in wanted))


@contextlib.contextmanager
def units(count):
    """``ops.flash_attention``, ``ops.ssd`` and ``ops.quantize`` as units of
    ``count`` while open; yields the list of K1's calls, each (shapes,
    causal, window, backward): ``backward`` True for a call whose inputs
    record a gradient and that runs outside the backward pass (a call the
    backward kernel will differentiate; a remat recompute runs inside the
    backward).  A call on DTensors passes through: ``ops`` runs each rank's
    shard through the same module attribute (``local_map``), and that
    local call is the unit."""
    calls = []
    inner = {name: getattr(ops, name) for name in ("flash_attention", "ssd", "quantize")}
    memo = {}

    def plain(key, fn, *inputs):
        """``fn(*inputs)`` inside the unit.  On meta its count depends on
        the shapes alone, so a repeat of a counted call (the same op at
        every layer) adds the first one's plain tally and returns empty
        results of its shapes, strides and dtypes without running."""
        if any(t.device.type != "meta" for t in inputs):
            with count.inside():
                return fn(*inputs)
        key = (key, *((tuple(t.shape), t.stride(), t.dtype) for t in inputs))
        if key not in memo:
            before = count.plain_tally()
            with count.inside():
                out = fn(*inputs)
            after = count.plain_tally()
            delta = (after[0] - before[0], after[1] - before[1], after[2] - before[2],
                     after[3] - before[3])
            memo[key] = delta, [(t.shape, t.stride(), t.dtype) for t in _tensors(out)]
            return out
        delta, specs = memo[key]
        count.add_plain(delta)
        outs = [torch.empty_strided(*spec[:2], dtype=spec[2], device="meta") for spec in specs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def unit_part(key):
        """``plain`` for the backward of a differentiated unit's call, keyed
        by ``key`` and by which of its outputs have a gradient."""
        return lambda used, fn, *inputs: plain((*key, "backward", used), fn, *inputs)

    def k1(q, k, v, *, causal=True, window=0, scale=None):
        kw = dict(causal=causal, window=window, scale=scale)
        if isinstance(q, DTensor):
            return inner["flash_attention"](q, k, v, **kw)
        in_backward = torch._C._current_autograd_node() is not None
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        calls.append({"q": tuple(q.shape), "k": tuple(k.shape), "v": tuple(v.shape),
                      "causal": causal, "window": window or 0,
                      "backward": grad and not in_backward})
        B, Sq, H, D = q.shape
        shape = (B, Sq, k.shape[1], H, k.shape[2], D, v.shape[3], q.element_size(),
                 causal, window or 0)
        count.unit(q.dtype, *roofline.attention_work(*shape))
        fn = lambda q_, k_, v_: inner["flash_attention"](q_, k_, v_, **kw)  # noqa: E731
        key = ("k1", causal, window, scale)
        if grad:
            bwd = (q.dtype, *roofline.attention_bwd_work(*shape))
            return _PlainUnit.apply(fn, count, lambda douts: bwd, unit_part(key), q, k, v)
        return plain(key, fn, q, k, v)

    def k3(x, dt, A, B, C, *, chunk=256):
        if isinstance(x, DTensor):
            return inner["ssd"](x, dt, A, B, C, chunk=chunk)
        shape = (*x.shape, B.shape[2], B.shape[3], chunk, x.element_size())
        count.unit(x.dtype, *roofline.ssd_work(*shape))
        fn = lambda *a: inner["ssd"](*a, chunk=chunk)  # noqa: E731
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
            def bwd(douts):   # the final state's gradient is read only when it is used
                return (x.dtype, *roofline.ssd_bwd_work(*shape, final_grad=douts[1] is not None))
            return _PlainUnit.apply(fn, count, bwd, unit_part(("k3", chunk)), x, dt, A, B, C)
        return plain(("k3", chunk), fn, x, dt, A, B, C)

    def k2(x, *, group=256):
        if isinstance(x, DTensor):
            return inner["quantize"](x, group=group)
        count.unit(x.dtype, *roofline.quantize_work(x.numel(), group, x.element_size()))
        with count.inside():
            return inner["quantize"](x, group=group)

    ops.flash_attention, ops.ssd, ops.quantize = k1, k3, k2
    try:
        yield calls
    finally:
        ops.flash_attention, ops.ssd, ops.quantize = (
            inner["flash_attention"], inner["ssd"], inner["quantize"])


def k1_flops(calls) -> int:
    """K1's operations over the recorded calls, the backward's too."""
    total = 0
    for c in calls:
        B, Sq, H, D = c["q"]
        args = (B, Sq, c["k"][1], H, D, c["v"][3], c["causal"], c["window"])
        total += k1_call_flops(*args)
        if c["backward"]:
            total += k1_call_flops(*args, backward=True)
    return total


def cell_args(model, shape, device, mesh=None, fsdp=True):
    """(step, args, {state, inputs, cache} of ``args``) for the cell on
    ``device``: on meta the specs and the abstract state, elsewhere
    parameters drawn from seed 0 and ``concrete_inputs``; on a ``mesh``
    (meta only) those placed as DTensors (:func:`placed_cell_args`, with
    ``fsdp``)."""
    if mesh is not None:
        return placed_cell_args(model, shape, mesh, fsdp=fsdp)
    cfg = model.cfg
    device = torch.device(device)
    meta = device.type == "meta"
    gen = torch.Generator("cpu" if meta else device).manual_seed(0)
    inputs = input_specs(cfg, shape) if meta else concrete_inputs(cfg, shape, device)
    if shape.kind == "train":
        opt = optimizer_for(cfg)
        state = (tsteps.abstract_train_state(model, opt) if meta
                 else tsteps.init_train_state(model, opt, gen))
        return tsteps.make_train_step(model, opt), (state, inputs), {
            "state": state, "inputs": inputs, "cache": None}
    params = model.init(gen, device)
    if shape.kind == "prefill":
        return tsteps.make_prefill_step(model, shape.seq), (params, inputs), {
            "state": params, "inputs": inputs, "cache": None}
    cache, tokens = inputs
    return tsteps.make_serve_step(model), (params, cache, tokens), {
        "state": params, "inputs": tokens, "cache": cache}


def placed_cell_args(model, shape, mesh, fsdp=True):
    """:func:`cell_args` on ``mesh``, as the JAX dry run's ``lower_cell``
    places the cell: the abstract state, inputs and cache as DTensors of
    ``meta`` shards, each rank its own shard (``src_data_rank=None``: no
    collective places anything), by ``train_shardings`` (FSDP on unless
    ``fsdp`` is false) or ``serve_shardings``, and the step under
    ``bind_mesh``.  A prefill's cache comes out placed by the cache's
    shardings, as JAX's ``out_shardings`` place it."""
    cfg = model.cfg

    def put(tree, placements):
        return shd.distribute(tree, mesh, placements, src_data_rank=None)

    if shape.kind == "train":
        opt = optimizer_for(cfg)
        spec = input_specs(cfg, shape)
        (state_pl, batch_pl), state = tsteps.train_shardings(model, opt, mesh, spec,
                                                             fsdp=fsdp)
        state, batch = put(state, state_pl), put(spec, batch_pl)
        return tsteps.bind_mesh(tsteps.make_train_step(model, opt), mesh), (state, batch), {
            "state": state, "inputs": batch, "cache": None}
    if shape.kind == "prefill":
        spec = input_specs(cfg, shape)
        shards, params = tsteps.serve_shardings(
            model, mesh, model.init_cache(shape.batch, shape.seq, device="meta"), batch_like=spec)
        params, batch = put(params, shards["params"]), put(spec, shards["batch"])
        prefill = tsteps.make_prefill_step(model, shape.seq)

        def step(p, b):
            logits, cache = prefill(p, b)
            return logits, _placed_as(cache, shards["cache"])

        return tsteps.bind_mesh(step, mesh), (params, batch), {
            "state": params, "inputs": batch, "cache": None}
    cache, tokens = input_specs(cfg, shape)
    shards, params = tsteps.serve_shardings(model, mesh, cache)
    params, cache = put(params, shards["params"]), put(cache, shards["cache"])
    tokens = put({"tokens": tokens}, {"tokens": shd.placements(
        shd.batch_specs({"tokens": tokens}, mesh)["tokens"], mesh)})["tokens"]
    return tsteps.bind_mesh(tsteps.make_serve_step(model), mesh), (params, cache, tokens), {
        "state": params, "inputs": tokens, "cache": cache}


def _placed_as(tree, placements):
    """Each DTensor of ``tree`` redistributed to its leaf of
    ``placements``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _placed_as(v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, DTensor) and tuple(tree.placements) != tuple(placements):
        return tree.redistribute(tree.device_mesh, placements)
    return tree


def _bytes_of(parts, out, kind):
    """{state, inputs, cache, outputs, resident}_bytes: a prefill's cache is
    the one it returns, a decode's the one it updates in place."""
    state, inputs = nbytes(parts["state"]), nbytes(parts["inputs"])
    if kind == "train":
        cache, outputs = 0, nbytes(out)
    elif kind == "prefill":
        cache, outputs = nbytes(out[1]), nbytes(out[0])
    else:
        cache, outputs = nbytes(parts["cache"]), nbytes(out[0])
    return {"state_bytes": state, "input_bytes": inputs, "cache_bytes": cache,
            "output_bytes": outputs, "resident_bytes": state + inputs + cache + outputs}


def counted_record(cfg, shape, device="meta", mesh=None, fsdp=True) -> dict:
    """The cell's run under :class:`LocalCount`, on meta (or, at small
    sizes, on the CPU), on one device or on ``mesh``'s rank 0 (a train
    cell's state placed with ``fsdp``): bytes, the counts, K1's calls and
    operations."""
    model = build(cfg)
    step, args, parts = cell_args(model, shape, device, mesh, fsdp)
    count = LocalCount(mesh_groups(mesh))
    t0 = time.perf_counter()
    with units(count) as calls, count:
        out = step(*args)
    rec = _bytes_of(parts, out, shape.kind)
    rec.update(fits_one_card=rec["resident_bytes"] <= CARD_BYTES, **count.record(),
               k1_calls=len(calls), k1_backward_calls=sum(c["backward"] for c in calls),
               k1_flops=k1_flops(calls), counted_s=time.perf_counter() - t0)
    return rec


def mesh_name(mesh) -> str:
    """"1x1" without a mesh, "single" / "multi" for the production meshes,
    else the mesh's shape ("2x2")."""
    if mesh is None:
        return "1x1"
    shape = tuple(mesh.shape)
    names = {(16, 16): "single", (2, 16, 16): "multi"}
    return names.get(shape, "x".join(map(str, shape)))


def _launches():
    """{kernel: launches} of the hand-written kernels' wrappers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize, ssd_scan
    return {"k1": fa.flash_attention_cuda.launches, "k1b": fa.flash_attention_bwd_cuda.launches,
            "k2": quantize.quantize_cuda.launches, "k3": ssd_scan.ssd_cuda.launches,
            "k3b": ssd_scan.ssd_bwd_cuda.launches}


def card_record(cfg, shape, *, reps=1, profile=False) -> dict:
    """The cell run ``reps`` times on the card from parameters drawn from
    seed 0: each step's ms (host clock around synchronised work), the
    peak of allocated memory from before the state was made, and the
    kernels' launches over all the steps.  A decode cell steps on from its
    own cache, a train cell from its own state.  With ``profile`` one more
    step runs under ``torch.profiler``: its device time by kernel (the
    largest ``TOP``) and its device-busy share (device time over that
    step's wall time, the profiler's own cost included)."""
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    step, args, parts = cell_args(model, shape, dev)
    before = _launches()
    times, finite = [], True
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        result = out["loss"] if shape.kind == "train" else out[0]
        finite &= bool(torch.isfinite(result).all())
        if shape.kind == "decode":
            args = (args[0], out[1], args[2])
    launches = {k: n - before[k] for k, n in _launches().items()}
    prof = _profiled(step, args) if profile else {}
    rec = {**prof, "step_ms": times, "ms": times[-1], "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(), "finite": finite,
           "outputs": (f"loss {float(out['loss']):.4f}, grad norm {float(out['grad_norm']):.4f}"
                       if shape.kind == "train" else f"logits {tuple(out[0].shape)}"),
           "output_shape": () if shape.kind == "train" else tuple(out[0].shape)}
    rec.update(_bytes_of(parts, out, shape.kind))
    del step, args, parts, out
    torch.cuda.empty_cache()
    return rec


def _profiled(step, args) -> dict:
    """One more step under the profiler: {profile_ms, device_ms, busy,
    top_kernels}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_serve import _device_ms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_ms(prof)
    device = sum(ms for _, ms in rows)
    return {"profile_ms": wall, "device_ms": device, "busy": device / wall,
            "top_kernels": [[name[:120], ms] for name, ms in rows[:TOP]]}


COUNT_KEYS = ("flops", "hbm_bytes", "work_flops", "work_flops_by_dtype", "work_hbm_bytes")


def run_cell(arch: str, shape_name: str, *, device="cuda", batch: int = 0, reps: int = 1,
             profile: bool = False, mesh=None, cfg=None, fsdp: bool = True) -> dict:
    """The record of one cell: ``status`` ``ok``, ``skipped`` (with
    ``applicable``'s reason) or ``error``; ``params`` and ``active_params``;
    the full shape's meta run (:func:`counted_record`), per device on
    ``mesh``; and at 1x1 with ``device`` cuda the card's run
    (:func:`card_record`) at the ``batch`` cut (0: the full batch, run only
    when it fits the card) under ``"card"``, with the cut's counts.
    ``cfg`` replaces the arch's registered config (``perf_probe``'s
    overrides).  ``fsdp`` false places a train cell's state on ``mesh``
    without FSDP (JAX's ``--no-fsdp``); an ``ok`` record carries it.  A
    mesh with ``device`` cuda raises: the mesh mode counts on meta only."""
    if mesh is not None and torch.device(device).type == "cuda":
        raise ValueError(f"the {mesh_name(mesh)} mesh is counted on meta only (no card runs "
                         f"{mesh.size()} ranks): pass device='cpu' / --device cpu")
    cfg = cfg or get_config(arch)
    full = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh), "kind": full.kind,
           "torch": torch.__version__,
           "seq": full.seq, "batch": full.batch, "devices": 1 if mesh is None else mesh.size(),
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    ok, reason = applicable(cfg, full)
    if not ok:
        return {**rec, "status": "skipped", "reason": reason}
    try:
        rec.update(counted_record(cfg, full, mesh=mesh, fsdp=fsdp))
        rec.update(status="ok", fsdp=fsdp)
        if torch.device(device).type == "cuda" and (batch or rec["fits_one_card"]):
            cut = scale_shape(full, batch=batch)
            counted = counted_record(cfg, cut) if cut.batch != full.batch else rec
            rec["card"] = {"batch": cut.batch,
                           **card_record(cfg, cut, reps=reps, profile=profile),
                           "count": {k: counted[k] for k in COUNT_KEYS}}
    except Exception as e:   # recorded per cell, as the JAX dry run records it
        rec.update(status="error", error=repr(e), traceback=traceback.format_exc())
    return rec


def summary(rec) -> str:
    """One line of a record."""
    if rec["status"] == "error":
        return " " + rec["error"][:200]
    if rec["status"] != "ok":
        return " " + rec["reason"]
    line = (f" resident={rec['resident_bytes'] / 2**30:.2f}GiB fits={rec['fits_one_card']}"
            f" flops={rec['flops']:.3e} work_flops={rec['work_flops']:.3e}"
            f" work_hbm={rec['work_hbm_bytes']:.3e}B k1_flops={rec['k1_flops']:.3e}")
    if rec["devices"] > 1:
        line += (f" wire={rec['wire_bytes']:.3e}B "
                 + " ".join(f"{k}={v}" for k, v in rec["collectives"].items()
                            if k.endswith("_count"))
                 + f" counted {rec['counted_s']:.1f}s")
    if "card" in rec:
        card = rec["card"]
        line += (f" card: batch {card['batch']} {card['ms']:.2f} ms peak "
                 f"{card['peak_bytes'] / 2**30:.2f}GiB launches {card['launches']}")
        if "busy" in card:
            line += (f" device {card['device_ms']:.2f} ms busy {card['busy']:.3f}; "
                     + "; ".join(f"{n[:60]} {ms:.2f}" for n, ms in card["top_kernels"][:6]))
    return line


_WORKER = {}


def _join(kind):
    """A pool worker's start: one intra-op thread, and for a production
    mesh its own fake world and mesh, kept until the worker exits."""
    torch.set_num_threads(1)
    if kind != "1x1":
        launch_mesh.join_fake_world(MESHES[kind])
        _WORKER["mesh"] = launch_mesh.make_production_mesh(multi_pod=kind == "multi",
                                                          device_type="cpu")


def _worker_cell(cell, kw):
    return run_cell(*cell, mesh=_WORKER.get("mesh"), **kw)


def run_cells(kind: str, cells, jobs: int = 1, **kw):
    """Yield the record of each (arch, shape) of ``cells``, in order, on
    the ``kind`` mesh ("1x1", "single" or "multi"; ``kw`` to
    :func:`run_cell`): a production mesh in a fake world of its ranks
    (``launch/mesh.py``), joined for these cells and left after; with
    ``jobs`` > 1 the cells are spread over that many worker processes,
    each in a fake world of its own (the cells are independent)."""
    if jobs <= 1:
        if kind == "1x1":
            for arch, shape in cells:
                yield run_cell(arch, shape, **kw)
            return
        with launch_mesh.fake_world(MESHES[kind]):
            mesh = launch_mesh.make_production_mesh(multi_pod=kind == "multi",
                                                    device_type="cpu")
            for arch, shape in cells:
                yield run_cell(arch, shape, mesh=mesh, **kw)
        return
    import functools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_join, initargs=(kind,)) as pool:
        yield from pool.map(functools.partial(_worker_cell, kw=kw), cells)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1", choices=("1x1", "single", "multi", "both"),
                    help="1x1: one device; single: 16x16 ('data', 'model'); multi: 2x16x16 "
                         "('pod', 'data', 'model'); both: single and multi")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda: also run each cell on the card (1x1 only); cpu: the meta run only")
    ap.add_argument("--batch", type=int, default=0, help="the card run's batch cut")
    ap.add_argument("--reps", type=int, default=1, help="steps the card run takes")
    ap.add_argument("--profile", action="store_true",
                    help="one more card step under torch.profiler: device time by kernel")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="place a train cell's state on the mesh without FSDP")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the meta runs (each its own fake world)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1" and args.device == "cuda":
        raise ValueError(f"--mesh {args.mesh} is counted on meta only: pass --device cpu")

    os.makedirs(args.out, exist_ok=True)
    archs = all_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(arch, shape) for arch in archs for shape in shapes]
    failures = 0
    for kind in ("single", "multi") if args.mesh == "both" else (args.mesh,):
        for rec in run_cells(kind, cells, args.jobs, device=args.device, batch=args.batch,
                             reps=args.reps, profile=args.profile, fsdp=not args.no_fsdp):
            tag = f"{rec['arch']}__{rec['shape']}__{kind}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            failures += rec["status"] == "error"
            print(f"[dryrun] {tag}: {rec['status']}{summary(rec)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
