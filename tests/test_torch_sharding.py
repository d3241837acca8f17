"""The port's partition rules (``repro_torch.parallel.sharding``) against the
JAX package's (``repro.parallel.sharding``), entry for entry: parameter
specs for all ten archs at SMOKE and full size, batch and cache specs, on
a (2, 2), a (3, 7) mesh (where nothing divides) and the two-pod (2, 16,
16) one, with FSDP on and off; ``constrain``'s per-dim choice against
JAX's; and DTensor placements that round-trip.  Abstract state only: the
port's on ``meta``, JAX's from ``jax.eval_shape``; no mesh of processes."""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.models.registry import build as jbuild
from repro.parallel import context as jctx
from repro.parallel import sharding as jshd
from repro_torch.checkpoint.manager import flatten
from repro_torch.configs import shapes
from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.train import steps as tsteps


class FakeMesh:
    """Axis names and sizes, as both packages' rules read them."""

    def __init__(self, sizes):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.devices = np.empty(self.shape)


MESHES = {"2x2": {"data": 2, "model": 2}, "3x7": {"data": 3, "model": 7},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SIZES = ("smoke", "full")


def _cfgs(arch, size):
    if size == "smoke":
        return jregistry.get_smoke(arch), get_smoke(arch)
    return jregistry.get_config(arch), get_config(arch)


@functools.lru_cache(maxsize=None)
def _states(arch, size):
    """(JAX's abstract train state, the port's on meta)."""
    from repro.optim.adamw import AdamW as JAdamW
    from repro.train import steps as jsteps
    jcfg, cfg = _cfgs(arch, size)
    return (jsteps.abstract_train_state(jbuild(jcfg), JAdamW()),
            tsteps.abstract_train_state(build(cfg), AdamW()))


def _jax_flat(tree):
    """{"a/b/c": spec tuple} from a JAX PartitionSpec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jshd.P))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}


def _port_flat(tree):
    return dict(flatten(tree))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", all_archs())
def test_param_specs_match_jax(arch, size, mesh, fsdp):
    jstate, state = _states(arch, size)
    m = FakeMesh(MESHES[mesh])
    for part in (("params",), ("opt", "m")):
        jtree, tree = jstate, state
        for k in part:
            jtree, tree = jtree[k], tree[k]
        want = _jax_flat(jshd.param_specs(jtree, m, fsdp=fsdp))
        got = _port_flat(shd.param_specs(tree, m, fsdp=fsdp))
        assert got == want


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", all_archs())
def test_batch_specs_match_jax(arch, mesh, kind):
    jcfg, cfg = _cfgs(arch, "full")
    m = FakeMesh(MESHES[mesh])
    want = _jax_flat(jshd.batch_specs(jshapes.input_specs(jcfg, jshapes.SHAPES[kind]), m))
    got = _port_flat(shd.batch_specs(shapes.input_specs(cfg, shapes.SHAPES[kind]), m))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", all_archs())
def test_cache_specs_match_jax(arch, size, mesh):
    jcfg, cfg = _cfgs(arch, size)
    shape = jshapes.SHAPES["decode_32k"] if size == "full" else \
        jshapes.scale_shape(jshapes.SHAPES["decode_32k"], seq=64, batch=4)
    m = FakeMesh(MESHES[mesh])
    jcache, _ = jshapes.input_specs(jcfg, shape)
    cache, _ = shapes.input_specs(cfg, shapes.Shape(shape.name, shape.kind, shape.seq,
                                                    shape.batch))
    assert _port_flat(shd.cache_specs(cache, m)) == _jax_flat(jshd.cache_specs(jcache, m))


# the constraints the models pin, at shapes where the axes divide and where not
CONSTRAINTS = [((4, 32, 4, 16), ("__dp__", None, "model", None)),      # GQA / MLA q, k, v
               ((3, 32, 14, 16), ("__dp__", None, "model", None)),
               ((4, 32, 64), ("__dp__", None, "model")),                  # SSD dt
               ((50,), ("model",)),                                       # SSD A
               ((4, 31, 256), ("__dp__", None, None)),                    # logits
               ((6, 32, 1, 16), ("__dp__", None, None, None)),            # SSD B, C
               ((32, 16), (("data", "model"), None))]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape,axes", CONSTRAINTS)
def test_constrain_chooses_as_jax(monkeypatch, shape, axes, mesh):
    m = FakeMesh(MESHES[mesh])
    seen = []
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda _mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    with jctx.with_mesh(m):
        jctx.constrain(np.zeros(shape, np.float32), axes)
    assert seen == [pctx.constrain_spec(shape, axes, m)]


def test_constrain_is_the_identity_off_a_mesh_and_for_plain_tensors():
    x = torch.zeros(4, 8)
    assert pctx.constrain(x, ("__dp__", None)) is x
    with pctx.with_mesh(FakeMesh(MESHES["2x2"])):
        assert pctx.constrain(x, ("__dp__", None)) is x
        assert pctx.model_size() == 2
    assert pctx.current_mesh() is None and pctx.model_size() == 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["llama3.2-1b", "arctic-480b", "whisper-small"])
def test_placements_round_trip(arch, mesh):
    m = FakeMesh(MESHES[mesh])
    _, state = _states(arch, "full")
    for key, spec in _port_flat(shd.param_specs(state["params"], m)).items():
        pl = shd.placements(spec, m)
        assert len(pl) == len(m.shape), key
        ndim = len(dict(flatten(state["params"]))[key].shape)
        assert shd.placements(shd.spec_of(pl, m, ndim), m) == pl, key


def test_a_tuple_of_axes_shards_one_dim_over_both():
    m = FakeMesh(MESHES["2x16x16"])
    assert shd.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements((), m) == (Replicate(),) * 3
    assert shd.spec_of((Shard(0), Shard(0), Shard(2)), m, 3) == (("pod", "data"), None, "model")
