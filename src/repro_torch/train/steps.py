"""Step builders: the port of ``repro.train.steps``, with the sharding
trees that place them on a device mesh.

The train step takes the loss's gradient with autograd (attention through
the backward kernel on the card), optionally int8-compresses every gradient
leaf (K2 on the card), and applies AdamW in place.  The prefill and serve
steps are the model's own entry points; ``abstract_train_state`` is the
train state on ``meta`` (the counterpart of ``jax.eval_shape``), which the
dry run (``launch/dryrun.py``) steps through.

On a mesh the state and batches are DTensors placed by
``train_shardings``/``serve_shardings``, and a step runs under
``bind_mesh``: DTensor's dispatch partitions the model's operations, as
JAX's pjit does, and each kernel runs on its rank's shard
(``kernels/ops.py``)."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.registry import Model
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.ranges import span

# the profiler ranges of a train step's phases (launch/profile_train.py reads them)
FORWARD_SPAN = "train.forward"
BACKWARD_SPAN = "train.backward"
COMPRESS_SPAN = "train.compress"
OPTIMIZER_SPAN = "train.optimizer"
PHASES = (FORWARD_SPAN, BACKWARD_SPAN, COMPRESS_SPAN, OPTIMIZER_SPAN)

def bind_mesh(fn, mesh):
    """``fn`` with ``mesh`` in scope (the expert-parallel MoE path reads
    it) and under DTensor's ``implicit_replication``: a plain tensor that
    the model makes itself (rope tables, masks, positions, constants) meets
    the DTensors as replicated on every rank, as GSPMD replicates a value
    it is not told to shard.  Each rank makes it alike."""
    if mesh is None:
        return fn

    def wrapped(*args, **kwargs):
        with pctx.with_mesh(mesh), implicit_replication():
            return fn(*args, **kwargs)

    return wrapped


def init_train_state(model: Model, optimizer: AdamW, gen: torch.Generator, device=None):
    """{"params", "opt"} on ``device`` (default ``gen.device``), parameters
    drawn from ``gen``."""
    params = model.init(gen, device)
    return {"params": params, "opt": optimizer.init(params)}


def abstract_train_state(model: Model, optimizer: AdamW):
    """The train state's shapes and dtypes as ``meta`` tensors: no memory
    is allocated and nothing is drawn."""
    return init_train_state(model, optimizer, torch.Generator().manual_seed(0), "meta")


def _unflatten_like(tree, it):
    return {k: _unflatten_like(v, it) if isinstance(v, dict) else next(it)
            for k, v in sorted(tree.items())}


def make_train_step(model: Model, optimizer: AdamW, *, compress: bool = False):
    """``step(state, batch) -> metrics``: one optimizer step that updates
    ``state`` in place (the counterpart of the JAX step's donated state).
    ``batch``: the model's batch on the state's device, {"tokens": (B, S)
    int} or, for the encoder-decoder, {"frames", "dec_tokens"}.  The
    metrics ("loss", "ce", "aux", "grad_norm") are 0-d tensors.  Its phases
    are the profiler ranges ``PHASES`` (``runtime/ranges.py``)."""
    def step(state, batch):
        params = state["params"]
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        try:
            with span(FORWARD_SPAN):
                loss, metrics = model.loss(params, batch)
            with span(BACKWARD_SPAN):
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a DTensor gradient comes back placed as its last operation left it
        # (a partial sum, say): place it as its parameter, as JAX's
        # out_shardings do, so the update below runs shard by shard
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) and g.placements != p.placements else g
                 for g, p in zip(grads, leaves)]
        grads = _unflatten_like(params, iter(grads))
        if compress:
            with span(COMPRESS_SPAN):
                grads = grad_compress.compress_tree(grads)
        with span(OPTIMIZER_SPAN):
            om = optimizer.update(grads, state["opt"], params)
        return {k: _whole(v.detach())
                for k, v in {**metrics, "loss": loss, **om}.items()}

    return step



def _whole(t):
    """A metric as a plain tensor, alike on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_prefill_step(model: Model, max_len: int):
    """``step(params, batch) -> (last logits, cache)``, the cache sized to
    ``max_len``."""
    def step(params, batch):
        return model.prefill(params, batch, max_len)
    return step


def make_serve_step(model: Model):
    """``step(params, cache, tokens) -> (logits, cache)``: one decode step;
    the cache's tensors are updated in place."""
    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return step


# ---------------------------------------------------------------- shardings

def train_shardings(model: Model, optimizer: AdamW, mesh, batch_like, *, fsdp: bool = True):
    """((state placements, batch placements), abstract state): the
    placement trees, each leaf a tuple of DTensor placements, one per mesh
    dim, for ``make_train_step``'s state (the moments follow the
    parameters; the step count is replicated) and for a batch shaped as
    ``batch_like``; the abstract state is ``abstract_train_state``'s."""
    state = abstract_train_state(model, optimizer)
    pspec = shd.param_specs(state["params"], mesh, fsdp=fsdp)
    mspec = shd.param_specs(state["opt"]["m"], mesh, fsdp=fsdp)
    spec = {"params": pspec, "opt": {"m": mspec, "v": mspec, "step": ()}}
    return (_placements(spec, mesh),
            _placements(shd.batch_specs(batch_like, mesh), mesh)), state


def serve_shardings(model: Model, mesh, cache_like, batch_like=None, *, fsdp: bool = False):
    """({"params", "cache"[, "batch"]} placement trees, abstract params):
    the serving counterpart of :func:`train_shardings`."""
    params = model.init(torch.Generator().manual_seed(0), "meta")
    out = {"params": _placements(shd.param_specs(params, mesh, fsdp=fsdp), mesh),
           "cache": _placements(shd.cache_specs(cache_like, mesh), mesh)}
    if batch_like is not None:
        out["batch"] = _placements(shd.batch_specs(batch_like, mesh), mesh)
    return out, params


def _placements(specs, mesh):
    return {k: _placements(v, mesh) if isinstance(v, dict) else shd.placements(v, mesh)
            for k, v in specs.items()}

