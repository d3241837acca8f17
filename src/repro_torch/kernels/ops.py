"""Dispatch to the hand-written kernels.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor goes to the kernel, whose wrapper launches it or raises.
There is no fallback from one to the other.  A tensor on ``meta`` (shapes
and dtypes only, no data: the dry run's route, ``launch/dryrun.py``) goes
to the plain version too, which is what the dry run counts.

``flash_attention`` and ``ssd`` also take DTensors (``parallel/``) in the
placements that ``parallel.context.constrain`` pins them to: the batch dim
sharded over the mesh's data axes, the heads over its ``model`` axis, or
either replicated.  Through ``local_map`` each runs the kernel (or, on the
CPU, the plain version) on each rank's own shard and wraps the result with
the matching placements.  An operand replicated on an axis where x is
sharded gets its gradient there as ``Partial()``: each rank's is only its
own shard's share of the sum.  Any other placement raises, and
``quantize`` raises on any DTensor: nothing here redistributes.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.ssd_scan import ssd as _ssd

PLAIN_DEVICES = ("cpu", "meta")   # the devices whose tensors take the plain versions


def _placed(t, batch_dim: int, head_dim):
    """``t``'s placements, checked: on the ``model`` axis ``Shard(head_dim)``
    or ``Replicate()``, on every other axis ``Shard(batch_dim)`` or
    ``Replicate()``."""
    for axis, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        want = head_dim if axis == "model" else batch_dim
        if not (isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == want)):
            raise ValueError(f"ops: {p} on mesh axis {axis!r} for a tensor of shape "
                             f"{tuple(t.shape)}; ops takes Shard({want}) or Replicate() "
                             f"there and does not redistribute")
    return tuple(t.placements)


def _matching(name, t, want):
    if not isinstance(t, DTensor) or tuple(t.placements) != tuple(want):
        got = tuple(t.placements) if isinstance(t, DTensor) else "a plain tensor"
        raise ValueError(f"ops: {name} is {got}, wants {tuple(want)}: each rank's shard "
                         f"must meet its own shards of the other operands")


def _like(placements, dims):
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``
    (``Replicate()`` where ``dims[d]`` is None)."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and dims[p.dim] is not None
                 else Replicate() for p in placements)


def _summed(placements, operand):
    """The placements of an operand's gradient under ``local_map``, given x's
    ``placements`` and the operand's own: ``Partial()`` on each axis where x
    is sharded and the operand replicated, since there each rank's gradient
    covers its own shard of x only and the whole is the sum over the axis;
    elsewhere as the operand is placed.  Without it DTensor takes one rank's
    share for the whole (dA over the data axes, dB and dC over ``model``)."""
    return tuple(Partial() if isinstance(o, Replicate) and isinstance(p, Shard) else o
                 for p, o in zip(placements, operand))


# ---------------------------------------------------------- flash attention

def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv) (MLA:
    D 96, Dv 64), which may be a strided view.  Returns (B, Sq, H, Dv).
    ``window`` None or 0 is off; ``scale`` defaults to 1/sqrt(D).  A query
    that sees no key gives 0 on both routes.  Differentiable on both:
    autograd through the plain version on the CPU, the backward kernel on
    the card.  The card's kernels take D and Dv up to 128 and raise above.
    DTensors: q, k and v in the same placements (batch dim 0, heads dim 2),
    so that each rank's query heads meet their own kv heads."""
    if isinstance(q, DTensor):
        pl = _placed(q, 0, 2)
        _matching("k", k, pl)
        _matching("v", v, pl)
        fn = functools.partial(flash_attention, causal=causal, window=window, scale=scale)
        return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl),
                         device_mesh=q.device_mesh)(q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return _ref.attention_ref(q, k, v, causal=causal, window=window or 0,
                                  scale=scale)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale)


# --------------------------------------------------------------------- SSD

def ssd(x, dt, A, B, C, *, chunk=256):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B, C: (b,s,g,n); ``s % chunk == 0``.
    Returns (y in x.dtype, final float32 state (b,h,p,n)).  Dtypes pass
    through as they come: nothing is cast on the host.  Differentiable on
    both routes: autograd through the plain version on the CPU, the
    backward kernel (``csrc/ssd_scan_bwd.cu``) on the card.  DTensors: x and dt
    with batch dim 0 and heads dim 2 placed alike, A's heads as x's, B and
    C as x's batch and replicated over ``model``, with one group (g = 1)
    where the heads are split; y is placed as x, the state (b,h,p,n) on
    the same batch and heads.  dA, dB and dC are partial sums where x is
    split and they are not (``_summed``)."""
    if isinstance(x, DTensor):
        pl = _placed(x, 0, 2)
        _matching("dt", dt, pl)
        apl = _like(pl, {0: None, 2: 0})
        _matching("A", A, apl)
        bc = _like(pl, {0: 0, 2: None})
        _matching("B", B, bc)
        _matching("C", C, bc)
        if B.shape[2] > 1 and any(isinstance(p, Shard) and p.dim == 2 for p in pl):
            # a rank's local heads would meet groups by their local index
            # (head i -> group i // (h_local / g)), not their global one
            raise ValueError(f"ops: ssd with heads split over 'model' takes one B/C group, "
                             f"got g = {B.shape[2]}; it does not regroup a rank's heads")
        return local_map(functools.partial(ssd, chunk=chunk),
                         out_placements=(pl, _like(pl, {0: 0, 2: 1})),
                         in_placements=(pl, pl, apl, bc, bc),
                         in_grad_placements=(pl, pl, _summed(pl, apl), _summed(pl, bc),
                                             _summed(pl, bc)),
                         device_mesh=x.device_mesh)(x, dt, A, B, C)
    if x.device.type in PLAIN_DEVICES:
        return _ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    return _ssd(x, dt, A, B, C, chunk=chunk)


# ----------------------------------------------------------------- quantize

def quantize(x, *, group=256):
    """Symmetric int8 group quantization along the last axis.  Returns
    (q int8 of x's shape, float32 scales (..., last / group)), the same bits
    on both routes.  It takes a rank's local tensor, not a DTensor: its
    callers choose the groups (``optim/grad_compress.py`` quantizes each
    shard of a DTensor gradient flattened, under its own ``local_map``)."""
    if isinstance(x, DTensor):
        raise ValueError(f"ops: quantize takes a rank's local tensor, got a DTensor placed "
                         f"{tuple(x.placements)}; it does not redistribute")
    if x.device.type in PLAIN_DEVICES:
        return _ref.quantize_ref(x, group=group)
    return quantize_cuda(x, group=group)


def dequantize(q, scale, *, group=256, dtype=torch.float32):
    """``q * scale`` in ``dtype``.  Plain torch on both devices: the JAX
    package has no kernel for it either."""
    return _ref.dequantize_ref(q, scale, group=group, dtype=dtype)
