"""The dry run's ``--no-fsdp`` (``repro_torch.launch.dryrun``) against the
JAX package's ``--no-fsdp`` placement.

The port's placements run in one subprocess, which joins fake worlds of
256 and 512 ranks in turn (``launch/mesh.py``; a tier-1 worker may hold a
process group of its own).  Only what is needed is placed: each arch's
train_4k state on (16, 16) and (2, 16, 16) with FSDP off, leaf by leaf.
One CLI run with ``--no-fsdp`` (llama3.2-1b train_4k on ``single``) shows
the flag reaching ``train_shardings`` and the record.

* For all ten archs on both production meshes, rank 0's train-state
  shards, leaf by leaf, equal the bytes of JAX's shards of the same leaves
  under ``param_specs(..., fsdp=False)`` (each dim divided by its axes'
  sizes, rounded up).
* The same state with FSDP on (JAX's ``fsdp=True`` shards) is smaller
  wherever FSDP shards a leaf: the flag changes what is placed.
* The CLI's record says ``"fsdp": false`` and its state bytes are the sum
  of JAX's FSDP-off shards.
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from repro.configs import registry as jregistry
from repro.models.registry import build as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel import sharding as jshd
from repro.train import steps as jsteps
from repro_torch.configs.registry import all_archs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CLI_CELL = ("llama3.2-1b", "train_4k", "single")

PORT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import all_archs, get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, mesh as lm
    from repro_torch.models.registry import build

    torch.set_num_threads(1)
    out = {"leaves": {}}
    for kind, n in (("single", 256), ("multi", 512)):
        with lm.fake_world(n):
            mesh = lm.make_production_mesh(multi_pod=kind == "multi", device_type="cpu")
            out["leaves"][kind] = {}
            for arch in all_archs():
                _, _, parts = dryrun.placed_cell_args(build(get_config(arch)),
                                                      SHAPES["train_4k"], mesh, fsdp=False)
                out["leaves"][kind][arch] = {k: dryrun.nbytes(v)
                                             for k, v in flatten(parts["state"])}
    arch, shape, mesh = %(cli)r
    out["rc"] = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                             "--device", "cpu", "--no-fsdp", "--out", sys.argv[1]])
    out["left"] = not dist.is_initialized()
    print(json.dumps(out))
""") % {"cli": CLI_CELL}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's FSDP-off placements and the CLI's record."""
    out = tmp_path_factory.mktemp("dryrun_nofsdp")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    res = subprocess.run([sys.executable, "-c", PORT, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    arch, shape, mesh = CLI_CELL
    with open(out / f"{arch}__{shape}__{mesh}.json") as f:
        got["record"] = json.load(f)
    return got


class FakeMesh:
    """Axis names and sizes, as JAX's rules read them."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        import numpy as np
        self.devices = np.empty(tuple(sizes.values()))


@functools.lru_cache(maxsize=None)
def jax_shard_bytes(arch, mesh, fsdp):
    """{leaf: bytes of rank 0's shard} of JAX's abstract train state on
    ``mesh`` with ``fsdp``: each dim divided by its axes' sizes, rounded
    up."""
    import jax.numpy as jnp
    cfg = jregistry.get_config(arch)
    opt = JAdamW(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
    state = jsteps.abstract_train_state(jbuild(cfg), opt)
    sizes = MESHES[mesh]
    fm = FakeMesh(sizes)
    pspec = jshd.param_specs(state["params"], fm, fsdp=fsdp)
    mspec = jshd.param_specs(state["opt"]["m"], fm, fsdp=fsdp)
    specs = {"params": pspec, "opt": {"m": mspec, "v": mspec, "step": jshd.P()}}
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    spec_leaves = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jshd.P))[0])
    out = {}
    for path, leaf in leaves:
        spec = tuple(spec_leaves[path]) + (None,) * len(leaf.shape)
        n = 1
        for dim, ax in zip(leaf.shape, spec):
            axes = () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        out["/".join(str(k.key) for k in path)] = n * jnp.dtype(leaf.dtype).itemsize
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", all_archs())
def test_state_bytes_per_device_without_fsdp_equal_jax_shards(port, arch, mesh):
    got = port["leaves"][mesh][arch]
    assert got == jax_shard_bytes(arch, mesh, False)
    on = jax_shard_bytes(arch, mesh, True)
    assert all(got[k] >= on[k] for k in on)
    assert sum(got.values()) > sum(on.values())


def test_the_cli_flag_reaches_the_record(port):
    rec = port["record"]
    assert port["rc"] == 0 and port["left"]
    assert rec["status"] == "ok" and rec["fsdp"] is False
    assert (rec["arch"], rec["shape"], rec["mesh"]) == CLI_CELL and rec["devices"] == 256
    assert rec["state_bytes"] == sum(jax_shard_bytes(CLI_CELL[0], CLI_CELL[2], False).values())
