"""The port's fault runtime (``repro_torch.runtime.fault``, a verbatim
copy) and elastic restore (``repro_torch.runtime.elastic`` and
``CheckpointManager.restore(slice_rows=...)``) against the JAX package's,
on the CPU: the scenarios of ``tests/test_runtime.py`` run through both
packages side by side, and a train state written by the port's manager is
restored shard by shard, at 1, 2 and 4 shards, by the port and by the JAX
package from the same file bytes.  No tolerance: every comparison is
exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.registry import get_smoke as jax_smoke
from repro.core import NVCache as JNVCache
from repro.core import Policy as JPolicy
from repro.models.registry import build as jax_build
from repro.runtime import elastic as jel
from repro.runtime import fault as jfault
from repro.storage.fsapi import NVCacheFS as JNVCacheFS
from repro.storage.tiers import DRAM as JDRAM
from repro.storage.tiers import Tier as JTier
from repro_torch.checkpoint import codec
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.convert import params_from_numpy
from repro_torch.core import NVCache, Policy
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import fault as tfault
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import DRAM, Tier

FAULT = {"jax": jfault, "port": tfault}
POL = dict(entry_size=16384, log_entries=8192, page_size=4096,
           read_cache_pages=64, batch_min=8, batch_max=512, verify_crc=False)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet(mon, n=8, spares=2):
    for i in range(n):
        mon.register(f"w{i}")
    for i in range(spares):
        mon.register(f"spare{i}", spare=True)


def _both(scenario):
    """``scenario(fault module)`` run on the JAX package's and the port's;
    the port's result, after asserting that the two are equal."""
    out = {name: scenario(mod) for name, mod in FAULT.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _plan(plan):
    return None if plan is None else dataclasses.asdict(plan)


def test_dead_worker_detection_and_failover():
    def scenario(mod):
        clk = FakeClock()
        mon = mod.HeartbeatMonitor(dead_after_s=30, clock=clk)
        _fleet(mon)
        mon.note_checkpoint(100)
        for t in range(5):
            clk.t = t * 10.0
            for i in range(8):
                if i != 3:                      # w3 dies after t=0
                    mon.beat(f"w{i}", t)
                elif t == 0:
                    mon.beat("w3", 0)
        plan = mon.plan()
        mon.apply(plan)
        return _plan(plan), sorted(mon.workers), list(mon.spares)

    plan, workers, spares = _both(scenario)
    assert plan["dead"] == ["w3"] and plan["replacements"] == {"w3": "spare0"}
    assert plan["restart_step"] == 100 and not plan["remesh"]
    assert "w3" not in workers and spares == ["spare1"]


def test_straggler_detection():
    def scenario(mod):
        clk = FakeClock()
        mon = mod.HeartbeatMonitor(dead_after_s=1e9, straggler_factor=2.0, clock=clk)
        _fleet(mon, n=6, spares=1)
        for step in range(10):
            for i in range(6):
                clk.t = step * 1.0 + (0.9 if i == 5 else 0.0)
                mon.beat(f"w{i}", step)
        before = mon.stragglers()        # same cadence: no straggler
        for step in range(10, 16):
            for i in range(5):
                clk.t = step * 1.0
                mon.beat(f"w{i}", step)
        for step in range(10, 16):       # w5 slows to 4x per step
            clk.t = 12 + (step - 10) * 4.0
            mon.beat("w5", step)
        return before, mon.stragglers(), _plan(mon.plan()), mon.workers["w5"].rate()

    before, after, plan, rate = _both(scenario)
    assert before == [] and after == ["w5"]
    assert plan["stragglers"] == ["w5"] and plan["replacements"] == {"w5": "spare0"}
    assert rate > 2.0


def test_remesh_when_spares_exhausted():
    def scenario(mod):
        clk = FakeClock()
        mon = mod.HeartbeatMonitor(dead_after_s=5, clock=clk)
        _fleet(mon, n=4, spares=1)
        for i in range(4):
            mon.beat(f"w{i}", 0)
        clk.t = 100.0
        mon.beat("w0", 1)
        return _plan(mon.plan())          # w1..w3 dead, only one spare

    plan = _both(scenario)
    assert len(plan["dead"]) == 3 and plan["remesh"]
    assert len(plan["replacements"]) == 1


def test_viable_mesh_shapes():
    assert tel.viable_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert tel.viable_mesh(256) == ((16, 16), ("data", "model"))
    assert tel.viable_mesh(240) == ((15, 16), ("data", "model"))
    shape, _ = tel.viable_mesh(200)          # 200 % 16 != 0 -> shrink TP
    assert shape[0] * shape[1] == 200
    for n in range(1, 1100):
        for kw in ({}, {"model_parallel": 8}, {"model_parallel": 4, "multi_pod_threshold": 64}):
            assert tel.viable_mesh(n, **kw) == jel.viable_mesh(n, **kw), (n, kw)


def test_shard_rows():
    assert tel.shard_rows("w", (64, 8), shard_idx=1, n_shards=4) == (16, 32)
    assert tel.shard_rows("w", (63, 8), shard_idx=1, n_shards=4) is None
    assert tel.shard_rows("s", (), shard_idx=0, n_shards=4) is None
    for shape in ((), (7,), (64,), (64, 8), (63, 8), (2, 64, 48), (256, 64), (12, 1, 1)):
        for n in (1, 2, 3, 4, 8):
            for i in range(n):
                assert (tel.shard_rows("k", shape, shard_idx=i, n_shards=n)
                        == jel.shard_rows("k", shape, shard_idx=i, n_shards=n)), (shape, n, i)


@pytest.fixture(scope="module")
def saved():
    """A whisper-small SMOKE train state (JAX's parameters, AdamW moments
    made non-zero, step 17) saved by the port's manager; the checkpoint's
    files, and the state as the port holds it."""
    params = jax.tree.map(np.asarray, jax_build(jax_smoke("whisper-small")).init(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(params, "cpu")
    state = {"params": tparams, "opt": AdamW(moment_dtype="bfloat16").init(tparams)}
    gen = torch.Generator().manual_seed(1)
    for key, leaf in flatten(state["opt"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen) if leaf.dim() else torch.tensor(17))
    nv = NVCache(Policy(**POL), Tier(DRAM))
    fs = NVCacheFS(nv)
    CheckpointManager(fs, encoding=codec.ENC_ZLIB).save(17, state)
    files = {}
    for p in ("/ckpt/MANIFEST.json", "/ckpt/step_00000017.ckpt"):
        fd = fs.open(p)
        files[p] = fs.pread(fd, fs.size(fd), 0)
        fs.close(fd)
    nv.shutdown()
    return files, state


def _manager(files, jax_side):
    nv = (JNVCache(JPolicy(**POL), JTier(JDRAM)) if jax_side
          else NVCache(Policy(**POL), Tier(DRAM)))
    fs = (JNVCacheFS if jax_side else NVCacheFS)(nv)
    for p, blob in files.items():
        fd = fs.open(p)
        fs.pwrite(fd, blob, 0)
        fs.close(fd)
    return nv, (JManager if jax_side else CheckpointManager)(fs)


def _bits(a):
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_reshard_restore_gives_each_shard_its_rows(saved, n_shards):
    """Every shard's slice of every leaf, as the port restores it, equals
    the rows JAX's ``shard_rows`` gives it of the full state (the whole
    leaf where it gives None), and what JAX's ``reshard_restore`` reads
    from the same file bytes."""
    files, state = saved
    nv, mgr = _manager(files, jax_side=False)
    jnv, jmgr = _manager(files, jax_side=True)
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), state)
    sliced = 0
    for idx in range(n_shards):
        got = flatten(tel.reshard_restore(mgr, state, shard_idx=idx, n_shards=n_shards))
        jgot = jax.tree.leaves(jel.reshard_restore(jmgr, like, shard_idx=idx,
                                                   n_shards=n_shards))
        assert len(got) == len(jgot) == len(flatten(state)) == 109
        for (key, a), (_, full), b in zip(got, flatten(state), jgot):
            rows = jel.shard_rows(key, tuple(full.shape), shard_idx=idx, n_shards=n_shards)
            want = full if rows is None else full[rows[0]:rows[1]]
            sliced += rows is not None and rows != (0, full.shape[0])
            assert a.dtype == full.dtype and a.shape == want.shape, key
            np.testing.assert_array_equal(_bits(a), _bits(want))
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert (sliced > 0) == (n_shards > 1)
    nv.shutdown()
    jnv.shutdown()


def test_restore_slice_rows_takes_any_row_range(saved):
    """``slice_rows`` as the JAX manager takes it: a row range per leaf by
    key and global shape, None for the whole leaf."""
    files, state = saved
    nv, mgr = _manager(files, jax_side=False)

    def slicer(key, shape):
        return (1, 3) if key == "params/embed" else None

    got = dict(flatten(mgr.restore(state, slice_rows=slicer)))
    assert torch.equal(got["params/embed"], state["params"]["embed"][1:3])
    for key, full in flatten(state):
        if key != "params/embed":
            np.testing.assert_array_equal(_bits(got[key]), _bits(full))
    nv.shutdown()
