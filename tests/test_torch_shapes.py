"""The port's input shapes (``repro_torch.configs.shapes``) against the JAX
package's (``repro.configs.shapes``): the cells, their applicability and
skip reasons, every input spec's shapes and dtypes leaf by leaf for all 40
full-width (arch x shape) cells (meta tensors against
``jax.ShapeDtypeStruct``s), and the concrete inputs, value for value, at
SMOKE sizes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes

ARCHS = treg.all_archs()
CELLS = [(a, s) for a in ARCHS for s in tshapes.SHAPES]


def _leaves(tree):
    """{key: leaf} of a dict, or of a (cache, tokens) pair."""
    if isinstance(tree, tuple):
        return {f"{i}/{k}": v for i, part in enumerate(tree) for k, v in _leaves(part).items()}
    return dict(flatten(tree)) if isinstance(tree, dict) else {"": tree}


def _jax_leaves(tree):
    if isinstance(tree, tuple):
        return {f"{i}/{k}": v for i, part in enumerate(tree)
                for k, v in _jax_leaves(part).items()}
    return dict(jax_flatten(tree)[0]) if isinstance(tree, dict) else {"": tree}


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


def test_shapes_and_whisper_length_match_jax():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in tshapes.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshapes.SHAPES[name])
    assert tshapes.WHISPER_ENC_LEN == jshapes.WHISPER_ENC_LEN
    assert tshapes.scale_shape(tshapes.SHAPES["train_4k"], seq=64) == tshapes.Shape(
        "train_4k", "train", 64, 256)
    assert dataclasses.astuple(tshapes.scale_shape(tshapes.SHAPES["decode_32k"], batch=2)) == \
        dataclasses.astuple(jshapes.scale_shape(jshapes.SHAPES["decode_32k"], batch=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_reasons_match_jax(arch):
    for name in tshapes.SHAPES:
        got = tshapes.applicable(treg.get_config(arch), tshapes.SHAPES[name])
        want = jshapes.applicable(jreg.get_config(arch), jshapes.SHAPES[name])
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax_leaf_by_leaf(arch, shape):
    """Every full-width cell, applicable or not (JAX builds the specs of a
    skipped cell too): the same leaves, shapes and dtypes, on meta."""
    got = _leaves(tshapes.input_specs(treg.get_config(arch), tshapes.SHAPES[shape]))
    want = _jax_leaves(jshapes.input_specs(jreg.get_config(arch), jshapes.SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert leaf.device.type == "meta", key
        assert tuple(leaf.shape) == tuple(want[key].shape), key
        assert _dtype_name(leaf.dtype) == str(want[key].dtype), key


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_inputs_match_jax_exactly_at_smoke_size(arch):
    """Integer leaves ``arange(last) % max(2, vocab - 1)`` (a 0-d one 0),
    float leaves 0.01 in their dtype: the same values as JAX's, at SMOKE
    configs and cut shapes, on the CPU."""
    tc, jc = treg.get_smoke(arch), jreg.get_smoke(arch)
    for name in tshapes.SHAPES:
        seq = 24 if tshapes.SHAPES[name].kind != "decode" else 40
        got = _leaves(tshapes.concrete_inputs(
            tc, tshapes.scale_shape(tshapes.SHAPES[name], seq=seq, batch=2), "cpu"))
        want = _jax_leaves(jshapes.concrete_inputs(
            jc, jshapes.scale_shape(jshapes.SHAPES[name], seq=seq, batch=2)))
        assert sorted(got) == sorted(want), (arch, name)
        for key, leaf in got.items():
            assert leaf.device.type == "cpu"
            w = np.asarray(want[key].astype(np.float32) if want[key].dtype == jax.numpy.bfloat16
                           else want[key])
            assert _dtype_name(leaf.dtype) == str(want[key].dtype), (arch, name, key)
            np.testing.assert_array_equal(leaf.float().numpy() if leaf.dtype == torch.bfloat16
                                          else leaf.numpy(), w, err_msg=f"{arch} {name} {key}")
