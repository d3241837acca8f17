"""The dry run's mesh mode (``repro_torch.launch.dryrun --mesh``) and its
counting (``LocalCount``, the kernels as units) against the JAX package.

The port's mesh runs happen in one subprocess, which joins fake worlds of
256, 512, 4 and 1 ranks in turn (``launch/mesh.py``): the tier-1 workers
may hold a process group of their own, and a fake world is joined only by
a process in none.  JAX's compiled SMOKE steps run in another, with eight
forced host devices, as ``tests/test_sharding.py`` runs them; both start
together.

* Per-device state bytes: for all ten archs at full size on (16, 16) and
  (2, 16, 16), rank 0's train-state shards, leaf by leaf, equal the bytes
  of JAX's shards of the same leaves (its specs, each dim divided by the
  axes' sizes, rounded up); llama3.2-1b train_4k on ``single`` end to end
  through ``run_cell``.
* SMOKE train steps (seq 32, batch 4) on a (2, 2) mesh against JAX's
  step compiled on one and read by ``benchmarks/hlo_analysis.analyze``:
  - dot FLOPs a device.  Both packages compute the same products (the
    plain attention's every score, remat "dots" recomputing attention):
    the port's one-device count equals 4x JAX's per-device count exactly
    for llama3.2-1b, XLA splitting every product four ways.  The port's
    count on the mesh is higher where DTensor's per-op strategy leaves a
    product's share above a quarter (measured with torch 2.13: the MLP's
    down projection h @ wd, whose contracting dim ``model`` shards and
    whose output dim FSDP shards, and its backward, +1,572,864 of
    19,398,656 for llama3.2-1b (8.1%); qwen3-moe-30b-a3b +15.3%, where
    JAX's partitioner also reshards the MoE's projections in its own way).
    Held: JAX's count <= the port's <= JAX's x 1.10 (llama3.2-1b) or 1.20
    (qwen3-moe-30b-a3b);
  - expert parallelism's all-to-alls (qwen3-moe-30b-a3b): JAX's on the
    ``model`` axis' groups (GSPMD's own resharding all-to-alls, on other
    groups, counted apart) against the port's ``all_to_all``: the same
    count; JAX's operand bytes twice the port's, since XLA's CPU backend
    carries the bf16 exchange as f32 (read off the HLO's dtype).
* Invariants: a (4, 1) data-only mesh counts a quarter of one device's
  FLOPs, plain and work; the (1, 1) mesh's record equals the one-device
  record, with no collective; a second join raises; leaving leaves no
  group.  In process, no mesh: inside a K1, K3 or K2 unit the plain
  version's ops add nothing to ``work_*``, and each call adds its own
  work (K1's ``k1_call_flops`` and ``attention_work`` bytes, its
  backward's too); the plain ``flops`` equal ``FlopCounterMode``'s;
  ``perf_probe``'s override changes the count; the CLI refuses a
  production mesh on the card.
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
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jregistry
from repro.models.registry import build as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel import sharding as jshd
from repro.train import steps as jsteps
from repro_torch.configs.registry import all_archs, get_smoke
from repro_torch.configs.shapes import SHAPES, scale_shape
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, perf_probe, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = (32, 4)                 # seq, batch of the SMOKE train cells
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
FLOP_SLACK = {"llama3.2-1b": 1.10, "qwen3-moe-30b-a3b": 1.20}
RECORD_KEYS = ("flops", "flops_by_op", "flops_by_dtype", "hbm_bytes", "work_flops",
               "work_flops_by_dtype", "work_hbm_bytes", "state_bytes", "input_bytes",
               "cache_bytes", "output_bytes", "k1_calls", "k1_flops", "collectives")

PORT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import all_archs, get_config, get_smoke
    from repro_torch.configs.shapes import SHAPES, scale_shape
    from repro_torch.launch import dryrun, mesh as lm
    from repro_torch.models.registry import build

    torch.set_num_threads(1)
    KEYS = %(keys)r
    out = {"leaves": {}, "smoke": {}}
    for kind, n in (("single", 256), ("multi", 512)):
        with lm.fake_world(n):
            mesh = lm.make_production_mesh(multi_pod=kind == "multi", device_type="cpu")
            out["leaves"][kind] = {}
            for arch in all_archs():
                _, _, parts = dryrun.placed_cell_args(build(get_config(arch)),
                                                      SHAPES["train_4k"], mesh)
                out["leaves"][kind][arch] = {k: dryrun.nbytes(v)
                                             for k, v in flatten(parts["state"])}
            if kind == "single":
                try:
                    lm.join_fake_world(4)
                    out["second_join"] = "joined"
                except RuntimeError as e:
                    out["second_join"] = str(e)
                out["llama_train_single"] = dryrun.run_cell(
                    "llama3.2-1b", "train_4k", device="cpu", mesh=mesh)
    shape = scale_shape(SHAPES["train_4k"], seq=%(seq)d, batch=%(batch)d)
    with lm.fake_world(4):
        m22 = lm.make_debug_mesh(2, 2, device_type="cpu")
        m41 = lm.make_debug_mesh(4, 1, device_type="cpu")
        for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
            out["smoke"][arch + " 2x2"] = dryrun.counted_record(get_smoke(arch), shape, mesh=m22)
        out["smoke"]["llama3.2-1b 4x1"] = dryrun.counted_record(
            get_smoke("llama3.2-1b"), shape, mesh=m41)
        # mamba2's step, and again with ops.ssd's gradients taken as placed
        # (each rank's share of dA, dB and dC as the whole, as before they
        # were declared partial): what the declared sums add
        from repro_torch.kernels import ops
        out["ssm"] = {"summed": dryrun.counted_record(get_smoke("mamba2-780m"), shape, mesh=m22)}
        summed, ops._summed = ops._summed, lambda placements, operand: tuple(operand)
        try:
            out["ssm"]["unsummed"] = dryrun.counted_record(get_smoke("mamba2-780m"), shape,
                                                           mesh=m22)
        finally:
            ops._summed = summed
        # a c10d collective (compressed_psum's all-gathers, K2 a unit) and
        # the GPipe schedule's one-peer all-to-alls, on a (4,) mesh
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.optim.grad_compress import compressed_psum
        from repro_torch.parallel.pipeline import pipeline_apply
        stages = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
        for name, fn in (("psum", lambda: compressed_psum(torch.empty(1000, device="meta"),
                                                          stages.get_group("stage"))),
                         ("pipeline", lambda: pipeline_apply(
                             stages, "stage", lambda p, x: x @ p,
                             torch.empty(4, 8, 8, device="meta"),
                             torch.empty(3, 2, 8, device="meta")))):
            count = dryrun.LocalCount(dryrun.mesh_groups(stages))
            with dryrun.units(count), count:
                fn()
            out[name] = count.record()
    with lm.fake_world(1):
        out["smoke"]["llama3.2-1b 1x1 mesh"] = dryrun.counted_record(
            get_smoke("llama3.2-1b"), shape, mesh=lm.make_debug_mesh(1, 1, device_type="cpu"))
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
        out["smoke"][arch + " 1x1"] = dryrun.counted_record(get_smoke(arch), shape)
    for k, rec in out["smoke"].items():
        out["smoke"][k] = {key: rec[key] for key in KEYS}
    out["left"] = not dist.is_initialized()
    print(json.dumps(out))
""") % {"keys": RECORD_KEYS, "seq": SMOKE[0], "batch": SMOKE[1]}

JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, os.path.join(%(repo)r, "benchmarks"))
    import jax
    import hlo_analysis
    from repro.configs.registry import get_smoke
    from repro.configs.shapes import SHAPES, input_specs, scale_shape
    from repro.models.registry import build
    from repro.optim.adamw import AdamW
    from repro.train import steps as tsteps

    shape = scale_shape(SHAPES["train_4k"], seq=%(seq)d, batch=%(batch)d)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
        cfg = get_smoke(arch)
        model = build(cfg)
        with mesh:
            opt = AdamW(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
            step = tsteps.bind_mesh(tsteps.make_train_step(model, opt), mesh)
            spec = input_specs(cfg, shape)
            (in_sh, b_sh), (out_sh, _), state = tsteps.train_shardings(model, opt, mesh, spec)
            text = jax.jit(step, in_shardings=(in_sh, b_sh), out_shardings=(out_sh, None),
                           donate_argnums=(0,)).lower(state, spec).compile().as_text()
        # the expert-parallel all-to-alls run on the model axis' groups
        # {0,1},{2,3}; GSPMD's own resharding all-to-alls, on other groups,
        # are counted apart (as collective-permutes)
        ep = "replica_groups={{0,1},{2,3}}"
        lines = [l if " all-to-all(" not in l or ep in l
                 else l.replace(" all-to-all(", " collective-permute(")
                 for l in text.splitlines()]
        r = hlo_analysis.analyze("\\n".join(lines))
        out[arch] = {"flops": r["flops"], "collectives": r["collectives"],
                     "ep_dtypes": sorted({l.split("= (")[1].split("[")[0] for l in lines
                                          if " all-to-all(" in l and "= (" in l})}
    print(json.dumps(out))
""") % {"repo": REPO, "seq": SMOKE[0], "batch": SMOKE[1]}


def _run(script, **env):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), **env}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """(the port's mesh runs, JAX's compiled SMOKE steps), both at once."""
    procs = [_run(PORT), _run(JAX, JAX_PLATFORMS="cpu")]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs


class FakeMesh:
    """Axis names and sizes, as JAX's rules read them."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        import numpy as np
        self.devices = np.empty(tuple(sizes.values()))


@functools.lru_cache(maxsize=None)
def jax_shard_bytes(arch, mesh):
    """{leaf: bytes of rank 0's shard} of JAX's abstract train state on
    ``mesh``: each dim divided by its axes' sizes, rounded up."""
    import jax.numpy as jnp
    cfg = jregistry.get_config(arch)
    opt = JAdamW(moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
    state = jsteps.abstract_train_state(jbuild(cfg), opt)
    sizes = MESHES[mesh]
    fm = FakeMesh(sizes)
    pspec = jshd.param_specs(state["params"], fm, fsdp=True)
    mspec = jshd.param_specs(state["opt"]["m"], fm, fsdp=True)
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


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", all_archs())
def test_state_bytes_per_device_equal_jax_shards(runs, arch, mesh):
    port = runs[0]["leaves"][mesh][arch]
    want = jax_shard_bytes(arch, mesh)
    assert port == want


def test_llama_train_4k_on_16x16_end_to_end(runs):
    rec = runs[0]["llama_train_single"]
    assert rec["status"] == "ok" and rec["mesh"] == "single" and rec["devices"] == 256
    assert rec["state_bytes"] == sum(jax_shard_bytes("llama3.2-1b", "single").values())
    assert rec["input_bytes"] == 256 // 16 * 4096 * 4       # rank 0's rows of tokens
    assert rec["fits_one_card"] and rec["resident_bytes"] < rec["state_bytes"] + 2**20
    assert 0 < rec["work_flops"] < rec["flops"] and rec["work_hbm_bytes"] < rec["hbm_bytes"]
    assert rec["k1_calls"] == 32 and rec["k1_backward_calls"] == 16
    # K1 at rank 0's shard: 16 of 256 rows, 2 of 32 heads (the kv heads
    # repeated to 32 under the model axis)
    assert rec["k1_flops"] == dryrun.k1_flops(
        [{"q": (16, 4096, 2, 64), "k": (16, 4096, 2, 64), "v": (16, 4096, 2, 64),
          "causal": True, "window": 0, "backward": b} for b in [True] * 16 + [False] * 16])
    assert set(rec["groups"]) == {"data", "model"}
    assert rec["groups"]["model"]["ranks"] == list(range(16))
    assert rec["groups"]["data"]["ranks"] == list(range(0, 256, 16))
    assert rec["wire_bytes"] == sum(g["wire_bytes"] for g in rec["groups"].values()) > 0
    for kind in ("all_gather", "reduce_scatter", "all_reduce"):
        assert rec["collectives"][kind + "_count"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b"])
def test_smoke_2x2_dot_flops_against_jax(runs, arch):
    port, jx = runs[0]["smoke"], runs[1][arch]
    got = port[f"{arch} 2x2"]["flops"]
    if arch == "llama3.2-1b":
        assert port[f"{arch} 1x1"]["flops"] == 4 * jx["flops"]
    assert jx["flops"] <= got <= FLOP_SLACK[arch] * jx["flops"], (got, jx["flops"])


def test_smoke_2x2_expert_all_to_alls_against_jax(runs):
    port = runs[0]["smoke"]["qwen3-moe-30b-a3b 2x2"]["collectives"]
    jx = runs[1]["qwen3-moe-30b-a3b"]
    assert port["all_to_all_count"] == jx["collectives"]["all-to-all_count"] == 12
    assert jx["ep_dtypes"] == ["f32"]                 # bf16 on the port's side
    assert jx["collectives"]["all-to-all_operand"] == 2 * port["all_to_all_operand"]


def test_smoke_2x2_ssm_step_sums_the_scans_partial_gradients(runs):
    """mamba2's 2x2 SMOKE step counts the sums ``ops.ssd``'s partial dA,
    dB and dC need, against the same count with them taken as placed: over
    ``data`` one all-reduce a layer of dA (float32, h values), over
    ``model`` at least one reduction a layer of dB and dC, at least their
    bytes (bf16, (B/2, S, g, n) each; DTensor reduce-scatters them with the
    rest of the conv output's gradient where that is sharded); nothing
    else."""
    cfg = get_smoke("mamba2-780m")
    got, was = (runs[0]["ssm"][k]["collectives_by_axis"] for k in ("summed", "unsummed"))
    assert set(got) == set(was) == {"data", "model"}
    extra = {axis: {k: got[axis].get(k, 0) - was[axis].get(k, 0)
                    for k in set(got[axis]) | set(was[axis])} for axis in got}
    layers, h = cfg.n_layers, cfg.ssm_heads
    assert {k: v for k, v in extra["data"].items() if v} == {
        "all_reduce_count": layers, "all_reduce_operand": layers * h * 4}
    model = {k: v for k, v in extra["model"].items() if v}
    assert set(model) <= {f"{kind}_{what}" for kind in ("all_reduce", "reduce_scatter")
                          for what in ("count", "operand")}, model
    reductions = sum(v for k, v in model.items() if k.endswith("_count"))
    reduced = sum(v for k, v in model.items() if k.endswith("_operand"))
    assert reductions >= layers
    assert reduced >= layers * 2 * (SMOKE[1] // 2) * SMOKE[0] * cfg.ssm_state * 2
    rec = runs[0]["ssm"]["summed"]
    assert rec["wire_bytes"] > runs[0]["ssm"]["unsummed"]["wire_bytes"]


# -------------------------------------------------------------- invariants

def test_a_data_only_mesh_counts_a_quarter(runs):
    smoke = runs[0]["smoke"]
    one, four = smoke["llama3.2-1b 1x1"], smoke["llama3.2-1b 4x1"]
    assert four["flops"] * 4 == one["flops"] and four["work_flops"] * 4 == one["work_flops"]
    assert not any(k.startswith("all_to_all") for k in four["collectives"])


def test_the_1x1_mesh_counts_as_one_device(runs):
    smoke = runs[0]["smoke"]
    assert smoke["llama3.2-1b 1x1 mesh"] == smoke["llama3.2-1b 1x1"]
    assert smoke["llama3.2-1b 1x1"]["collectives"] == {}


def test_a_second_join_raises_and_leaving_leaves_no_group(runs):
    assert runs[0]["second_join"].startswith("this process already belongs to a process group")
    assert runs[0]["left"]


def test_c10d_and_one_peer_collectives_are_counted(runs):
    """``compressed_psum``'s two c10d all-gathers (1000 values padded to
    1024 int8 and 4 float32 scales, to four ranks: each rank receives
    three times what it sends) and the GPipe schedule's shifts, an
    all-to-all to one peer each tick (M + n - 1 = 6), then its sum."""
    psum, pipe = runs[0]["psum"], runs[0]["pipeline"]
    assert psum["collectives"] == {"all_gather_count": 2, "all_gather_operand": 1040,
                                   "all_gather_wire": 3 * 1040}
    assert psum["groups"]["stage"] == {"size": 4, "ranks": [0, 1, 2, 3], "wire_bytes": 3120}
    assert psum["work_hbm_bytes"] > roofline.quantize_work(1024, 256, 4)[1]
    assert pipe["collectives"]["collective_permute_count"] == 6
    assert pipe["collectives"]["collective_permute_operand"] == 6 * 2 * 8 * 4
    assert pipe["collectives"]["all_reduce_count"] == 1
    assert "all_to_all_count" not in pipe["collectives"]


def test_a_production_mesh_on_the_card_raises(tmp_path):
    with pytest.raises(ValueError, match="meta only"):
        dryrun.main(["--mesh", "single", "--device", "cuda", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="meta only"):
        dryrun.main(["--mesh", "both", "--out", str(tmp_path)])     # cuda is the default
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------- units

def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("causal, window, Skv", [(True, 0, 96), (True, 24, 96),
                                                 (False, 0, 160)])
@pytest.mark.parametrize("grad", [False, True])
def test_k1_unit_counts_its_own_work(causal, window, Skv, grad):
    B, Sq, H, KV, D, Dv = 2, 96, 4, 2, 32, 16
    q, k, v = _meta(B, Sq, H, D, grad=grad), _meta(B, Skv, KV, D, grad=grad), \
        _meta(B, Skv, KV, Dv, grad=grad)
    count = dryrun.LocalCount()
    with dryrun.units(count) as calls, count:
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
    shape = (B, Sq, Skv, H, KV, D, Dv, 2, causal, window)
    flops, nbytes = roofline.attention_work(*shape)
    assert flops == roofline.k1_call_flops(B, Sq, Skv, H, D, Dv, causal, window)
    assert count.record()["work_flops"] == flops and count.work_hbm_bytes == nbytes
    assert count.flops > 0 and len(calls) == 1 and calls[0]["backward"] == grad
    if grad:
        plain_fwd = count.flops
        with dryrun.units(count), count:
            torch.autograd.grad(o, (q, k, v), _meta(B, Sq, H, Dv))
        bflops, bbytes = roofline.attention_bwd_work(*shape)
        rec = count.record()
        assert rec["work_flops"] == flops + bflops and count.work_hbm_bytes == nbytes + bbytes
        assert count.flops > plain_fwd         # the plain backward, in the plain tally only
    # the bound column reads the same work
    assert roofline.attention_bound(*shape, roofline.PEAK_BF16_FLOPS)[0] == pytest.approx(
        max(flops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.PEAK_BYTES) * 1e3)


def test_k1_backward_unit_gives_the_plain_gradients():
    """On the CPU the unit's backward differentiates the plain version: the
    gradients are autograd's through it."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=g, requires_grad=True) for _ in range(3))
    want = torch.autograd.grad(ops.flash_attention(q, k, v).square().sum(), (q, k, v))
    count = dryrun.LocalCount()
    with dryrun.units(count), count:
        got = torch.autograd.grad(ops.flash_attention(q, k, v).square().sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k3_and_k2_units_count_their_own_work():
    b, s, h, p, g, n, chunk = 2, 128, 4, 16, 1, 8, 32
    args = (_meta(b, s, h, p), _meta(b, s, h, dtype=torch.float32),
            _meta(h, dtype=torch.float32), _meta(b, s, g, n), _meta(b, s, g, n))
    count = dryrun.LocalCount()
    with dryrun.units(count), count:
        y, state = ops.ssd(*args, chunk=chunk)
        first = count.plain_tally()
        y2, state2 = ops.ssd(*args, chunk=chunk)        # a repeat: the same plain tally
    flops, nbytes = roofline.ssd_work(b, s, h, p, g, n, chunk, 2)
    assert count.record()["work_flops"] == 2 * flops and count.work_hbm_bytes == 2 * nbytes
    assert count.flops == 2 * first[0] > 0 and count.hbm_bytes == 2 * first[3]
    assert (y2.shape, y2.dtype, y2.stride(), state2.shape, state2.dtype) == (
        y.shape, y.dtype, y.stride(), state.shape, state.dtype)
    count = dryrun.LocalCount()
    with dryrun.units(count), count:
        ops.quantize(_meta(1024, dtype=torch.float32), group=256)
    assert count.record()["work_flops"] == 0
    assert count.work_hbm_bytes == roofline.quantize_work(1024, 256, 4)[1] == 1024 * 5 + 16
    assert count.hbm_bytes > 0


@pytest.mark.parametrize("final", [False, True])
def test_k3_backward_unit_counts_its_own_work(final):
    """Under autograd K3 is one unit each way: its forward adds ``ssd_work``,
    its backward ``ssd_bwd_work`` (with the final state's gradient read only
    when the state is used), the plain backward in the plain tally only."""
    b, s, h, p, g, n, chunk = 2, 128, 4, 16, 1, 8, 32
    args = (_meta(b, s, h, p, grad=True), _meta(b, s, h, dtype=torch.float32, grad=True),
            _meta(h, dtype=torch.float32, grad=True), _meta(b, s, g, n, grad=True),
            _meta(b, s, g, n, grad=True))
    count = dryrun.LocalCount()
    with dryrun.units(count), count:
        y, state = ops.ssd(*args, chunk=chunk)
    plain_fwd = count.flops
    outs, grads = (y, state), (_meta(b, s, h, p), _meta(b, h, p, n, dtype=torch.float32))
    with dryrun.units(count), count:
        torch.autograd.grad(outs[:1 + final], args, grads[:1 + final])
    shape = (b, s, h, p, g, n, chunk, 2)
    flops, nbytes = roofline.ssd_work(*shape)
    bflops, bbytes = roofline.ssd_bwd_work(*shape, final_grad=final)
    assert count.record()["work_flops"] == flops + bflops
    assert count.work_hbm_bytes == nbytes + bbytes
    assert count.flops > plain_fwd
    assert roofline.ssd_bwd_work(*shape, final_grad=True)[1] == (
        roofline.ssd_bwd_work(*shape)[1] + 4 * b * h * p * n)


def test_k3_backward_unit_gives_the_plain_gradients():
    """On the CPU the unit's backward differentiates the plain version, the
    final state unused: the gradients are autograd's through ``ssd_ref``."""
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(1, 32, 2, 8, generator=g), torch.rand(1, 32, 2, generator=g),
            -torch.rand(2, generator=g), torch.randn(1, 32, 1, 8, generator=g),
            torch.randn(1, 32, 1, 8, generator=g)]
    args = [t.requires_grad_() for t in args]
    want = torch.autograd.grad(ops.ssd(*args, chunk=16)[0].square().sum(), args)
    count = dryrun.LocalCount()
    with dryrun.units(count), count:
        got = torch.autograd.grad(ops.ssd(*args, chunk=16)[0].square().sum(), args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_flops_are_flop_counter_modes():
    """The record's ``flops`` keep their meaning: what ``FlopCounterMode``
    counts of the same step."""
    cfg = get_smoke("qwen3-moe-30b-a3b")
    shape = scale_shape(SHAPES["train_4k"], seq=SMOKE[0], batch=SMOKE[1])
    rec = dryrun.counted_record(cfg, shape)
    model = dryrun.build(cfg)
    step, args, _ = dryrun.cell_args(model, shape, "meta")
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert rec["flops"] == fc.get_total_flops()
    assert rec["flops_by_op"] == {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_perf_probe_override_changes_the_count():
    """remat "dots" recomputes attention in the backward: ``remat=none``
    takes exactly that recompute (K1's second forward a layer) out."""
    dots = perf_probe.probe("llama3.2-1b", "train_4k", mesh="1x1")
    none = perf_probe.probe("llama3.2-1b", "train_4k", mesh="1x1",
                            **perf_probe.parse_overrides(["remat=none"]))
    assert (dots["k1_calls"], none["k1_calls"]) == (32, 16)
    assert dots["work_flops"] - none["work_flops"] == dots["k1_flops"] - none["k1_flops"] > 0
    assert perf_probe.parse_overrides(["remat=none", "n_layers=4", "norm_eps=1e-6"]) == {
        "remat": "none", "n_layers": 4, "norm_eps": "1e-6"}
