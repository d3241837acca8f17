"""Greedy decode replayed as CUDA graphs: ``launch/serve.py``'s ``decode``
on the card.

One graph holds one step of the eager loop: the argmax of the last logits,
the token as int32, ``decode_step``.  It runs over static buffers: the
logits (B, 1, V), a cache with the caller's keys and shapes (``pos``
included), and the token, which the graph's argmax writes.  ``decode_step``'s
new logits and ``pos`` are copied into the static ones inside the graph.  A
step then costs the host one launch where the eager step costs one launch
a kernel (thousands a step at full width), and the card, not the host,
sets the pace.

A graph is captured on first use of a shape, after one warm-up step on a
side stream.  The key is what the code can observe: the config, the
parameters' addresses (a graph bakes them in), and the logits' and every
cache tensor's shape and dtype.  mamba2's cache has no sequence axis, so
every prompt length shares one graph; an attention cache is sized by the
prompt, so each length has its own.

What stays resident is bounded by the largest shape served, not by the
number of shapes.  The graphs of one parameter tree share one flat buffer
a cache key (``logits``, ``k``, ``ssm_state``, ...), sized to the largest
such tensor seen; a shape's static tensors are contiguous views of their
starts.  A shape that does not fit grows the buffers and captures every
resident graph again over the new ones, so each shape seen stays ready.  At
most ``MAX_GRAPHS`` graphs stay, the least recently used dropped first; they
share one memory pool, as no two replays overlap.  The graphs and buffers
of a parameter tree go when any of its tensors is freed.

A decode copies the caller's logits and cache into the static views,
replays the graph once a token, and leaves the caller's cache as eager
decode leaves it: the rows the steps wrote, the SSM states whole, and
``pos`` bound to a new tensor, as ``decode_step`` rebinds it.  ``COUNTS``
counts captures, captures again after growth, replays and eager steps.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import weakref

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.lm import SSM_KEYS
from repro_torch.optim.adamw import tree_leaves

# families whose decode step runs host code that a replay would skip: the
# MoE layer appends to ``moe.count_drops``'s list and opens the ``moe.*``
# ranges, the encoder-decoder opens ``encdec.cross_attention``; both ranges
# are read a decode step by ``launch/profile_serve.py``
EAGER_FAMILIES = frozenset({"moe", "encdec"})

# graphs kept a parameter tree: a served set of prompt lengths up to this
# many is captured once.  Each graph holds its token (B, 1) in the
# allocator and, outside it, the card's copy of its kernels' arguments
# (~12 MB for hymba-1.5b's 4,091 kernels a step)
MAX_GRAPHS = 16


@dataclasses.dataclass
class Counts:
    captures: int = 0       # graphs captured for a shape not resident
    recaptures: int = 0     # resident graphs captured again over grown buffers
    replays: int = 0        # decode steps replayed as a graph
    eager_steps: int = 0    # decode steps run op by op


COUNTS = Counts()


def _step(model, params, logits, cache):
    """One step of eager decode on the static buffers, in place; returns
    the token."""
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    new_logits, new_cache = model.decode_step(params, dict(cache), tok)
    logits.copy_(new_logits)
    cache["pos"].copy_(new_cache["pos"])
    return tok


@functools.cache
def _side_stream(device):
    """The stream of warm-ups and captures, one a device: capture needs a
    stream other than the default one, and each stream holds a cuBLAS
    workspace for as long as the process runs."""
    return torch.cuda.Stream(device)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor
    cache: dict
    tok: torch.Tensor       # (B, 1) int32, written by each replay


class _Graphs:
    """The graphs of one parameter tree and the buffers they share."""

    def __init__(self, device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.buffers = {}                           # (cache key, dtype) -> flat tensor
        self.graphs = collections.OrderedDict()     # shapes -> _Graph, least recently used first

    def get(self, model, params, shapes) -> _Graph:
        g = self.graphs.get(shapes)
        if g is not None:
            self.graphs.move_to_end(shapes)
            return g
        if len(self.graphs) == MAX_GRAPHS:
            self.graphs.popitem(last=False)
        grow = [((k, dt), s.numel()) for k, s, dt in shapes
                if (k, dt) not in self.buffers or self.buffers[k, dt].numel() < s.numel()]
        if grow:
            resident = list(self.graphs)
            self.graphs.clear()     # they read the buffers, which go before the new ones come
            self.pool = torch.cuda.graph_pool_handle()  # the old one went with its last graph
            for b, n in grow:
                self.buffers.pop(b, None)
                self.buffers[b] = torch.empty(n, dtype=b[1], device=self.device)
            for r in resident:
                self.graphs[r] = self._capture(model, params, r, warm=False)
                COUNTS.recaptures += 1
        g = self.graphs[shapes] = self._capture(model, params, shapes)
        COUNTS.captures += 1
        return g

    def _capture(self, model, params, shapes, warm=True) -> _Graph:
        """Warm up one step on the side stream (lazy initialisation, cuBLAS's
        workspace), where the shape has not run before, then capture one
        into the pool."""
        cache = {k: self.buffers[k, dt][:s.numel()].view(s) for k, s, dt in shapes}
        for v in cache.values():
            v.zero_()       # position 0, zero states: a valid step, whatever the buffers held
        logits = cache.pop("logits")
        current = torch.cuda.current_stream(self.device)
        stream = _side_stream(self.device)
        stream.wait_stream(current)
        if warm:
            with torch.cuda.stream(stream):
                _step(model, params, logits, cache)
            current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # capture_begin, not torch.cuda.graph, which first empties the
        # allocator's cache: the next prefills would cudaMalloc it all again.
        # thread_local: a serving process's other threads (the request log's)
        # may run while this one captures
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                tok = _step(model, params, logits, cache)
            finally:
                graph.capture_end()
        return _Graph(graph, logits, cache, tok)


class Replay:
    """One decode of ``n_tokens`` as replays of ``g``: the caller's logits
    and cache copied in, then ``step`` once a token, then ``finish``."""

    def __init__(self, g: _Graph, logits, cache, n_tokens: int):
        self.g, self.cache = g, cache
        g.logits.copy_(logits)
        for k, v in cache.items():
            g.cache[k].copy_(v)
        self.tokens = torch.empty((logits.shape[0], n_tokens), dtype=torch.int32,
                                  device=logits.device)

    def step(self, i: int):
        """Token ``i``: the graph's replay and the token's copy into the
        output."""
        self.g.graph.replay()
        self.tokens[:, i:i + 1].copy_(self.g.tok)
        COUNTS.replays += 1

    def finish(self):
        """(tokens, last logits); the caller's cache left as eager decode
        leaves it."""
        g, cache, n = self.g, self.cache, self.tokens.shape[1]
        rows = cache["pos"].long() + torch.arange(n, device=self.tokens.device)
        for k, v in cache.items():
            if k in SSM_KEYS:
                v.copy_(g.cache[k])
            elif k != "pos":     # (L, B, S, ...): the rows the steps wrote
                v.index_copy_(2, rows, g.cache[k].index_select(2, rows))
        cache["pos"] = g.cache["pos"].clone()
        return self.tokens, g.logits.clone()


_TREES: dict = {}   # (config, the parameter leaves' addresses) -> _Graphs


def replay_for(model, params, logits, cache, n_tokens: int):
    """A ``Replay`` of ``n_tokens`` for these inputs, capturing its graph
    on first use of their shapes.  None, for the eager loop, for no
    tokens, in a family of ``EAGER_FAMILIES``, off a CUDA device, outside
    ``inference_mode`` (the static buffers are inference tensors), and for
    a mesh's DTensors."""
    if (n_tokens < 1 or model.cfg.family in EAGER_FAMILIES or not logits.is_cuda
            or not torch.is_inference_mode_enabled()):
        return None
    leaves = list(tree_leaves(params))
    if any(isinstance(t, DTensor) for t in (logits, *cache.values(), *leaves)):
        return None
    key = (model.cfg, *(t.data_ptr() for t in leaves))
    graphs = _TREES.get(key)
    if graphs is None:
        graphs = _TREES[key] = _Graphs(logits.device)
        for t in leaves:    # the graphs read the parameters where they lie
            weakref.finalize(t, _TREES.pop, key, None)
    shapes = tuple((k, v.shape, v.dtype) for k, v in (("logits", logits), *cache.items()))
    return Replay(graphs.get(model, params, shapes), logits, cache, n_tokens)
