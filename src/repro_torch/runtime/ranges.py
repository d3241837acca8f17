"""Named ranges on the profiler's timeline: the port's one way to mark a
stretch of host work for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs and a shared do-nothing context otherwise, so the main path
pays one flag read a range with tracing off.  A range is a host event on
the clock of the trace's CUDA events: a reader puts device time down to
the range it falls in, and nesting on one thread is the parent link.

Ranges sit at the layer boundaries:

* the train loop (``train/loop.py``), once a step: ``train.batch`` (the
  pipeline's draw and its copy to the device), ``train.step`` (the step
  through the host reading its metrics, so the wait for the device is in
  it), ``train.log`` (the durable metrics line);
* the train step (``train/steps.py``), inside ``train.step``:
  ``train.forward``, ``train.backward``, ``train.compress``,
  ``train.optimizer``;
* serving (``launch/serve.py``): ``serve.prefill`` once a prefill,
  ``serve.decode_step`` once a generated token;
* the hand-written kernels (``kernels/``): ``k1.fwd``, ``k1.bwd``,
  ``k2.quantize``, ``k3.fwd``, ``k3.bwd``, each around the call of the
  library's entry point alone (the outputs and scratch it allocates and
  zeroes lie outside), so a range holds that kernel's launches and no
  other device work;
* the MoE layer's ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and
  the encoder-decoder's ``encdec.cross_attention``.

A range has a reader: the loop's and serving's are read by the
benchmark's metrics (``bench/metrics/``), the step's phases and the
kernels' by ``launch/profile_train.py`` and ``launch/profile_serve.py``,
the MoE and encoder-decoder ranges by ``launch/profile_serve.py``.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

NAMES = frozenset({
    "train.batch", "train.step", "train.log",
    "train.forward", "train.backward", "train.compress", "train.optimizer",
    "serve.prefill", "serve.decode_step",
    "k1.fwd", "k1.bwd", "k2.quantize", "k3.fwd", "k3.bwd",
    "moe.dispatch", "moe.experts", "moe.combine", "encdec.cross_attention",
})

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs; otherwise
    the one shared null context (nothing is allocated or recorded).
    ``name`` is one of ``NAMES``."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
