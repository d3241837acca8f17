"""Model families: everything about a model that the benchmark's weights,
reference and work count must know, one module a family, found by name.
A configuration's ``model.family`` ``<family>`` is
``bench/families/<family>.py``, which defines:

* ``leaf_specs(m)``: {path: (shape, init, std)} of the model ``m`` (a
  configuration file's ``model``) in the program's parameter layout, and
  optionally ``INITS``, {init: fn(shape, std, gen, device)}, init kinds of
  its own beside ``reference.weights.INITS``;
* ``hidden(m, params, tokens, mm=f32_mm, remat=False)``: the plain
  float32 forward to the final normed hidden states, every product
  through ``mm``;
* ``forward_flops(m, B, S, *, unembed_all=True)``: the forward's model
  FLOPs (``work.flops``);
* ``ssd_scans(m)``: [(layers, h, p, g, n, chunk)], one entry a kind of
  SSD scan in the model, empty for a model with none.

The building blocks they share stay in ``reference.model``,
``reference.weights``, ``work.flops`` and ``work.ssd``."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(family: str, directory: Path = HERE):
    """The module ``<directory>/<family>.py``, loaded anew and made the one
    that :func:`of` returns for ``family``."""
    path = Path(directory) / f"{family}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no module for model family {family!r}: add {path}")
    spec = importlib.util.spec_from_file_location(f"{__name__}.{family}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[spec.name]
        raise
    return mod


def of(m: dict):
    """The module of the model ``m``'s family: the one loaded last, else
    this directory's."""
    return sys.modules.get(f"{__name__}.{m['family']}") or load(m["family"])
