"""The port's distribution layer on four gloo processes on the CPU, mesh
("data", "model") = (2, 2), against the unsharded port and the JAX package.

One job of four ranks (``_job``) runs every case once and rank 0 writes the
results to a file; one subprocess with four fake XLA devices computes the
JAX references; the tests read both.  Each rank joins through a
``FileStore`` under the test's temporary directory (no TCP port), and every
process is bounded by a timeout.

Tolerances: the sharded llama3.2-1b SMOKE train step under the bounds of
``tests/test_sharding.py::test_pjit_8dev_matches_single_device`` (bf16
compute: loss 2e-2; parameters 2·lr + 1e-4, Adam's first step moves each by
±lr with the sign set by sums in another order, so these bounds pass any
gradient); the same step at float32 compute, its gradient leaf by leaf
within 1e-4·(max|ref| + |ref|) of the unsharded one's, and compressed also
within one int8 step of the leaf, max|ref| / 127; float32 forwards 1e-4·(1 +
|ref|) (sums in another order over shards); ``_moe_shard_map`` 1e-5 in
float32 against JAX's and its gradients 1e-4·(1 + |ref|) against an
unsharded emulation of the same per-rank groups; ``compressed_psum``
1e-5·(1 + |ref|) against JAX's (K2's true division can move a scale by an
ulp); ``pipeline_apply`` forward 1e-5 and gradients 1e-4, the bounds of
``tests/test_pipeline.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
LR = 1e-3
ARCHS_FWD = ("llama3.2-1b", "granite-20b", "mamba2-780m", "hymba-1.5b")
# served through serve_shardings: the kv caches as cache_specs places them,
# batch over data and kv heads over model (llama's 2) or, for granite's one
# kv head, the sequence over model (a context-parallel cache)
SERVE_ARCHS = {"llama3.2-1b": "(Shard(dim=1), Shard(dim=3))",
               "granite-20b": "(Shard(dim=1), Shard(dim=2))"}
# the pipeline case of tests/test_pipeline.py: 8 layers in 4 stages of 2,
# 6 microbatches of 4 rows of 16
L, D, M, MB = 8, 16, 6, 4
PSUM_SHAPE = (3, 100)
MOE_SHAPE = (4, 16)          # (B, S) of the MoE layer's input


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    bs = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return Ws, bs, x


def _psum_inputs():
    rng = np.random.default_rng(1)
    return rng.standard_normal((WORLD, *PSUM_SHAPE)).astype(np.float32)


def _moe_inputs():
    from repro_torch.configs.registry import get_smoke
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"), compute_dtype="float32")
    rng = np.random.default_rng(2)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wu": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wd": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((*MOE_SHAPE, d))
    return cfg, {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


# ------------------------------------------------------------ the torch job

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def _train_step_cases(mesh, res, arch="llama3.2-1b", prefix=""):
    """``arch``'s SMOKE train step, sharded and unsharded from one state,
    in bf16 and float32 compute, plain and compressed; results under keys
    that start with ``prefix``."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as tsteps
    smoke = get_smoke(arch)
    tokens = np.random.default_rng(3).integers(0, smoke.vocab, (4, 32))
    batch = {"tokens": _t(tokens)}
    # bf16 compute (the config's) under JAX's bounds; float32 compute for
    # the gradients themselves
    for compute in ("bfloat16", "float32"):
        model = build(dataclasses.replace(smoke, compute_dtype=compute))
        opt = AdamW(lr=LR)
        for compress in (False, True):
            kind = "compressed" if compress else "plain"
            key, gkey = f"{prefix}step_{kind}", f"{prefix}grad_{kind}"
            step = tsteps.make_train_step(model, opt, compress=compress)
            ref = tsteps.init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
            state = tsteps.init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
            m1 = step(ref, batch)
            (placed, bplaced), _ = tsteps.train_shardings(model, opt, mesh, batch)
            sstate = shd.distribute(state, mesh, placed, src_data_rank=None)
            before = [tuple(t.placements) for t in tree_leaves(sstate)]
            m2 = tsteps.bind_mesh(step, mesh)(sstate, shd.distribute(batch, mesh, bplaced,
                                                                      src_data_rank=None))
            after = [tuple(t.placements) for t in tree_leaves(sstate)]
            whole = shd.full(sstate)
            if compute == "float32":
                # the first moment after one step is (1 - b1)·(clipped)
                # gradient: each leaf's, flattened, unsharded then sharded
                ms = [(a.float().reshape(-1), b.float().reshape(-1))
                      for a, b in zip(tree_leaves(ref["opt"]["m"]),
                                      tree_leaves(whole["opt"]["m"]))]
                res[gkey] = np.stack(
                    [np.concatenate([_np(p[i]) for p in ms]) / (1 - opt.b1) for i in (0, 1)])
                res[f"{gkey}_sizes"] = np.array([a.numel() for a, _ in ms])
                res[f"{gkey}_names"] = np.array([k for k, _ in flatten(ref["opt"]["m"])])
                res[f"{gkey}_sharded"] = np.array(
                    [any(not p.is_replicate() for p in t.placements)
                     for t in tree_leaves(sstate["opt"]["m"])])
                continue
            res[f"{key}_loss"] = np.array([float(m1["loss"]), float(m2["loss"])])
            res[f"{key}_param_delta"] = np.array(max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(ref["params"]), tree_leaves(whole["params"]))))
            res[f"{key}_placements_kept"] = np.array(before == after)
            res[f"{key}_sharded_leaves"] = np.array(sum(
                any(not p.is_replicate() for p in pl) for pl in after))


def _forward_cases(mesh, res):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import build
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as tsteps
    for arch in ARCHS_FWD:
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(1), "cpu")
        tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 32))
        batch = {"tokens": _t(tokens)}
        with torch.no_grad():
            want, _ = model.forward(params, batch)
            sp = shd.distribute(params, mesh, shd.param_specs(params, mesh), src_data_rank=None)
            sb = shd.distribute(batch, mesh, shd.batch_specs(batch, mesh), src_data_rank=None)
            got, _ = tsteps.bind_mesh(model.forward, mesh)(sp, sb)
        res[f"fwd_{arch}"] = np.stack([_np(want), _np(got)])


def _serve_cases(mesh, res):
    for arch in SERVE_ARCHS:
        _serve_case(mesh, res, arch)


def _serve_case(mesh, res, arch):
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.registry import build
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as tsteps
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    tokens = _t(np.random.default_rng(6).integers(0, cfg.vocab, (4, 24)))
    prompt = {"tokens": tokens[:, :16]}
    placed, _ = tsteps.serve_shardings(model, mesh, model.init_cache(4, 24, device="meta"),
                                       prompt)
    sp = shd.distribute(params, mesh, placed["params"], src_data_rank=None)
    prefill = tsteps.bind_mesh(tsteps.make_prefill_step(model, 24), mesh)
    decode = tsteps.bind_mesh(tsteps.make_serve_step(model), mesh)
    with torch.no_grad():
        want, cache = model.prefill(params, prompt, 24)
        got, scache = prefill(sp, shd.distribute(prompt, mesh, placed["batch"],
                                                 src_data_rank=None))
        wants, gots = [want], [got]
        for i in range(16, 24):
            t = {"tokens": tokens[:, i:i + 1]}
            want, cache = model.decode_step(params, cache, t["tokens"])
            got, scache = decode(sp, scache, shd.distribute(
                t, mesh, shd.batch_specs(t, mesh), src_data_rank=None)["tokens"])
            wants.append(want)
            gots.append(got)
    res[f"serve_{arch}"] = np.stack([np.stack([_np(w) for w in wants]),
                                     np.stack([_np(g) for g in gots])])
    res[f"serve_{arch}_cache"] = np.array(str(tuple(scache["k"].placements)))


def _moe_case(mesh, res):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as tsteps
    cfg, p_np, x_np = _moe_inputs()
    B, S = MOE_SHAPE
    p = {k: _t(v).requires_grad_(True) for k, v in p_np.items()}
    x = _t(x_np).requires_grad_(True)
    cot = _t(np.random.default_rng(5).standard_normal(x_np.shape).astype(np.float32))

    # the unsharded emulation: each rank's block of tokens (batch rows over
    # data, sequence over model) routed as one group at its own capacity
    def emulate(p, x):
        T = (B // 2) * (S // 2)
        c = dataclasses.replace(cfg, moe_group=T)
        rows, auxes = [], []
        for dr in range(2):
            cols = []
            for mr in range(2):
                blk = x[dr * B // 2:(dr + 1) * B // 2, mr * S // 2:(mr + 1) * S // 2]
                y, aux = moe._moe_gather(c, p, blk)
                cols.append(y)
                auxes.append(aux)
            rows.append(torch.cat(cols, 1))
        return torch.cat(rows, 0), torch.stack(auxes).mean()

    want, want_aux = emulate(p, x)
    wgrads = torch.autograd.grad((want * cot).sum() + want_aux, [x, *p.values()])
    with moe.count_drops() as want_drops:
        emulate(p, x)

    sp = shd.distribute({"moe": p}, mesh, shd.param_specs({"moe": p}, mesh),
                        src_data_rank=None)["moe"]
    sp = {k: v.detach().requires_grad_(True) for k, v in sp.items()}
    sx = shd.distribute({"x": x.detach()}, mesh, {"x": (("data",), None, None)},
                        src_data_rank=None)["x"].detach().requires_grad_(True)
    scot = DTensor.from_local(cot, mesh, [Replicate(), Replicate()])

    def run(sp, sx):
        got, aux = moe.moe_forward(cfg, sp, sx)
        loss = (got * scot.redistribute(mesh, got.placements)).sum() + aux
        return got, aux, torch.autograd.grad(loss, [sx, *sp.values()])

    with moe.count_drops() as drops:
        got, aux, ggrads = tsteps.bind_mesh(run, mesh)(sp, sx)
    total = torch.tensor(float(sum(int(d) for d in drops)))
    torch.distributed.all_reduce(total)
    res["moe_y"] = np.stack([_np(want), _np(got)])
    res["moe_aux"] = np.array([float(want_aux), float(_np(aux))])
    res["moe_drops"] = np.array([float(sum(int(d) for d in want_drops)), float(total),
                                 len(drops)])
    res["moe_placements"] = np.array([str(tuple(got.placements)), str(tuple(sx.placements))])
    for name, a, b in zip(["x", *p], wgrads, ggrads):
        res[f"moe_grad_{name}"] = np.stack([_np(a), _np(b)])
    res["moe_idx"] = moe._route(cfg, p["router"].detach(), x.detach().reshape(B * S, -1))[1] \
        .numpy()


def _ops_refusal_cases(mesh, res):
    """kernels/ops.py takes DTensors only in the placements constrain pins
    and raises on any other, with no redistribution of its own."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops

    def place(t, *pl):
        return distribute_tensor(t, mesh, list(pl), src_data_rank=None)

    gen = torch.Generator().manual_seed(8)
    q = torch.randn(4, 8, 4, 16, generator=gen)
    cases = {
        "sequence_over_model": lambda: ops.flash_attention(
            *(place(q, Shard(0), Shard(1)) for _ in range(3))),
        "kv_unlike_q": lambda: ops.flash_attention(
            place(q, Shard(0), Shard(2)), place(q, Shard(0), Replicate()),
            place(q, Shard(0), Shard(2))),
        "ssd_A_unlike_x": lambda: ops.ssd(
            place(torch.randn(4, 16, 4, 8, generator=gen), Shard(0), Shard(2)),
            place(torch.rand(4, 16, 4, generator=gen), Shard(0), Shard(2)),
            place(-torch.rand(4, generator=gen), Replicate(), Replicate()),
            *(place(torch.randn(4, 16, 1, 8, generator=gen), Shard(0), Replicate())
              for _ in range(2)),
            chunk=8),
        "quantize_last_dim": lambda: ops.quantize(
            place(torch.randn(4, 512, generator=gen), Replicate(), Shard(1))),
    }
    for name, call in cases.items():
        try:
            call()
            res[f"refuses_{name}"] = np.array("accepted")
        except ValueError as exc:
            res[f"refuses_{name}"] = np.array(str(exc))
    ok = ops.flash_attention(*(place(q, Shard(0), Shard(2)) for _ in range(3)))
    res["ops_local_heads"] = np.stack([_np(ok), _np(ops.flash_attention(q, q, q))])


def _psum_case(res):
    import torch.distributed as dist
    from repro_torch.optim.grad_compress import compressed_psum
    xs = _psum_inputs()
    rank = dist.get_rank()
    for dtype in ("float32", "bfloat16"):
        x = _t(xs[rank]).to(getattr(torch, dtype))
        out = compressed_psum(x, dist.group.WORLD)
        alike = [torch.empty_like(out) for _ in range(WORLD)]
        dist.all_gather(alike, out)
        res[f"psum_{dtype}"] = out.float().numpy()
        res[f"psum_{dtype}_alike"] = np.array(all(torch.equal(a, out) for a in alike))


def _pipeline_case(res):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    Ws, bs, x = _pipeline_inputs()
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
    staged = split_stages((_t(Ws), _t(bs)), WORLD)
    params = tuple(distribute_tensor(a, mesh, [Shard(0)], src_data_rank=None)
                   .requires_grad_(True) for a in staged)

    def stage_fn(p, h):
        for w, b in zip(*p):
            h = torch.tanh(h @ w + b)
        return h

    out = pipeline_apply(mesh, "stage", stage_fn, params, _t(x))
    (out ** 2).sum().backward()
    res["pipe_out"] = _np(out)
    res["pipe_grad_W"] = _np(params[0].grad).reshape(Ws.shape)
    res["pipe_grad_b"] = _np(params[1].grad).reshape(bs.shape)


def _resume_case(mesh, res, arch="llama3.2-1b", prefix=""):
    """``train_loop.train`` on the mesh for ``arch``'s SMOKE model: 5 steps
    straight, and 3 then a resume to 5 from the checkpoint at 3."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import NVCache, Policy
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW
    from repro_torch.storage.fsapi import NVCacheFS
    from repro_torch.storage.tiers import DRAM, Tier
    from repro_torch.train import loop as train_loop
    cfg = get_smoke(arch)
    model, opt = build(cfg), AdamW(lr=LR)
    pol = Policy(entry_size=16384, log_entries=2048, read_cache_pages=64, batch_min=8,
                 batch_max=512, verify_crc=False)

    def run(fs, steps):
        pipe = SyntheticTokens(cfg.vocab, 4, 32, seed=7)
        _, hist = train_loop.train(model, opt, pipe, fs, total_steps=steps, ckpt_every=3,
                                   mesh=mesh, device="cpu")
        return [h["loss"] for h in hist], pipe.step

    nv_once, nv = NVCache(pol, Tier(DRAM)), NVCache(pol, Tier(DRAM))
    try:
        straight, _ = run(NVCacheFS(nv_once), 5)
        first, _ = run(NVCacheFS(nv), 3)
        resumed, at = run(NVCacheFS(nv), 5)
    finally:
        nv_once.shutdown()
        nv.shutdown()
    res[f"{prefix}resume_losses"] = np.array([straight, first + resumed])
    res[f"{prefix}resume_counts"] = np.array([len(first), len(resumed), at, dist.get_rank()])


def _job(rank, store, out):
    """One rank of the job: every case, rank 0 writes the results."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    init_distributed(device_type="cpu", store_path=store, rank=rank, world_size=WORLD)
    mesh = make_debug_mesh(device_type="cpu")
    res = {}
    for case in (_train_step_cases, _forward_cases, _serve_cases, _moe_case,
                 _ops_refusal_cases):
        case(mesh, res)
    _psum_case(res)
    _pipeline_case(res)
    _resume_case(mesh, res)
    psum = {k: v for k, v in res.items() if k.startswith("psum_")}
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, psum)
    if rank == 0:
        for r, g in enumerate(gathered):
            res.update({f"{k}_rank{r}": v for k, v in g.items()})
        np.savez(out, **res)
    dist.destroy_process_group()


# --------------------------------------------------------------- JAX side

JAX_SUBPROC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, {tests!r})
    import test_torch_mesh as t
    from repro.configs.registry import get_smoke
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe
    from repro.optim.grad_compress import compressed_psum
    from repro.parallel.pipeline import pipeline_apply, split_stages
    import dataclasses
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    res = {{}}
    Ws, bs, x = t._pipeline_inputs()
    mesh = jax.make_mesh((4,), ("stage",))
    staged = split_stages((jnp.asarray(Ws), jnp.asarray(bs)), 4)

    def stage_fn(p, h):
        def body(hh, wb):
            return jnp.tanh(hh @ wb[0] + wb[1]), None
        return jax.lax.scan(body, h, p)[0]

    with mesh:
        out = jax.jit(lambda p, x: pipeline_apply(mesh, "stage", stage_fn, p, x))(
            staged, jnp.asarray(x))
        g = jax.jit(jax.grad(lambda p, x: jnp.sum(
            pipeline_apply(mesh, "stage", stage_fn, p, x) ** 2)))(staged, jnp.asarray(x))
    res["pipe_out"] = np.asarray(out)
    res["pipe_grad_W"] = np.asarray(g[0]).reshape(Ws.shape)
    res["pipe_grad_b"] = np.asarray(g[1]).reshape(bs.shape)

    xs = t._psum_inputs()
    pmesh = jax.make_mesh((4,), ("data",))
    for dtype in ("float32", "bfloat16"):
        kw = dict(mesh=pmesh, in_specs=P("data"), out_specs=P("data"))
        fn = lambda xl: compressed_psum(xl[0], "data")[None]
        try:
            f = shard_map(fn, check_vma=False, **kw)
        except TypeError:
            f = shard_map(fn, check_rep=False, **kw)
        res["psum_" + dtype] = np.asarray(jax.jit(f)(jnp.asarray(xs, dtype)).astype(jnp.float32))

    _, p, xm = t._moe_inputs()
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"), compute_dtype="float32")
    dmesh = make_debug_mesh(2, 2)
    with dmesh:
        y, aux = jax.jit(lambda p, x: moe._moe_shard_map(cfg, p, x, dmesh, 2))(
            {{k: jnp.asarray(v) for k, v in p.items()}}, jnp.asarray(xm))
    res["moe_y"] = np.asarray(y)
    res["moe_aux"] = np.asarray(aux)
    B, S = t.MOE_SHAPE
    res["moe_idx"] = np.asarray(moe._route(cfg, jnp.asarray(p["router"]),
                                           jnp.asarray(xm).reshape(B * S, -1))[1])
    np.savez(sys.argv[1], **res)
""")


def _wait(procs, what):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail(f"{what}: timed out after {TIMEOUT} s")
        outs.append((p.returncode, out, err))
    bad = [(rc, err[-3000:]) for rc, _, err in outs if rc != 0]
    assert not bad, f"{what} failed: {bad[0]}"
    return outs


# the launcher under torchrun: 3 steps on the CPU, rank 0 checkpoints at 3
TORCHRUN = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(WORLD),
            "-m", "repro_torch.launch.train", "--mesh", "debug", "--smoke", "--device", "cpu",
            "--steps", "3", "--ckpt-every", "3", "--compress-grads", "--log-mib", "8"]


# chip_smoke.py's phase 7 part (a) (launch/mesh_check.py) on the CPU at
# SMOKE size: one process, the 1x1 mesh over gloo
MESH_CHECK = textwrap.dedent("""
    import json, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch import mesh_check
    out = [mesh_check.single_mesh(get_smoke("llama3.2-1b"), device="cpu", batch=2, seq=64,
                                  lr=1e-3)]
    out += [mesh_check.ssm_serve(get_smoke(a), device="cpu", batch=2, seq=64)
            for a in ("mamba2-780m", "hymba-1.5b")]
    out += [mesh_check.ranks_psum("cpu"), mesh_check.ranks_pipeline("cpu")]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(torch results, JAX results, the torchrun launcher's stdout): the
    four-rank job, the JAX reference subprocess and the launcher, run side
    by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    store, out, jout = tmp / "store", tmp / "torch.npz", tmp / "jax.npz"
    env = _env()

    def start(*args, cwd=None):
        return subprocess.Popen([sys.executable, *args], env=env, cwd=cwd, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    jax_proc = start("-c", JAX_SUBPROC.format(tests=str(ROOT / "tests")), str(jout))
    ranks = [start("-c", f"import test_torch_mesh as t; t._job({r}, {str(store)!r}, "
                         f"{str(out)!r})") for r in range(WORLD)]
    launcher = start(*TORCHRUN, cwd=tmp)
    checker = start("-c", MESH_CHECK)
    _wait(ranks, "the four-rank job")
    _wait([jax_proc], "the JAX reference")
    (_, launched, _), = _wait([launcher], "torchrun -m repro_torch.launch.train")
    (_, checked, _), = _wait([checker], "launch/mesh_check.py on the CPU")
    return (dict(np.load(out)), dict(np.load(jout)), launched,
            json.loads(checked.strip().splitlines()[-1]))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), float(err.max())


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_sharded_train_step_within_jax_bounds(results, kind):
    got = results[0]
    loss = got[f"step_{kind}_loss"]
    assert abs(loss[0] - loss[1]) < 2e-2, loss
    assert float(got[f"step_{kind}_param_delta"]) <= 2 * LR + 1e-4
    assert bool(got[f"step_{kind}_placements_kept"])
    assert int(got[f"step_{kind}_sharded_leaves"]) > 0


@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_sharded_train_step_gradients_match_unsharded(results, kind):
    """The gradient each step applied, read from the first moment, sharded
    against unsharded at float32 compute, leaf by leaf.  Compressed, each
    side rounds to its own int8 groups (a shard's, against the whole
    leaf's), so each element may also differ by up to a group's scale,
    at most the leaf's largest |g| / 127."""
    got = results[0]
    want, have = got[f"grad_{kind}"]
    sizes = got[f"grad_{kind}_sizes"]
    assert got[f"grad_{kind}_sharded"].sum() > 0
    for w, h in zip(np.split(want, np.cumsum(sizes)[:-1]), np.split(have, np.cumsum(sizes)[:-1])):
        top = np.abs(w).max()
        assert top > 0
        rounding = top / 127 if kind == "compressed" else 0.0
        assert np.all(np.abs(h - w) <= rounding + 1e-4 * (top + np.abs(w))), \
            float(np.abs(h - w).max() / top)


@pytest.mark.parametrize("arch", ARCHS_FWD)
def test_sharded_forward_matches_unsharded(results, arch):
    want, got = results[0][f"fwd_{arch}"]
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(results, arch):
    want, got = results[0][f"serve_{arch}"]
    _close(got, want, 1e-4)
    assert str(results[0][f"serve_{arch}_cache"]) == SERVE_ARCHS[arch]


def test_moe_shard_map_matches_jax(results):
    got, jx = results[:2]
    np.testing.assert_array_equal(got["moe_idx"], jx["moe_idx"])     # routes held equal
    _close(got["moe_y"][1], jx["moe_y"], 1e-5)
    _close(got["moe_aux"][1], jx["moe_aux"], 1e-5)
    assert "Shard(dim=1)" in str(got["moe_placements"][0])           # the sequence over model


@pytest.mark.parametrize("name", ["x", "router", "wg", "wu", "wd"])
def test_moe_shard_map_grads_match_an_unsharded_emulation(results, name):
    want, got = results[0][f"moe_grad_{name}"]
    _close(got, want, 1e-4)


def test_moe_shard_map_counts_drops(results):
    got = results[0]
    emulated, sharded, calls = got["moe_drops"]
    assert sharded == emulated and calls == 1
    _close(got["moe_y"][1], got["moe_y"][0], 1e-5)


@pytest.mark.parametrize("case", ["sequence_over_model", "kv_unlike_q", "ssd_A_unlike_x",
                                  "quantize_last_dim"])
def test_ops_refuses_placements_it_does_not_take(results, case):
    said = str(results[0][f"refuses_{case}"])
    assert said != "accepted" and said.startswith("ops:"), said


def test_ops_runs_each_rank_on_its_own_heads(results):
    got, want = results[0]["ops_local_heads"]
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_jax(results, dtype):
    got, jx = results[:2]
    for r in range(WORLD):
        assert bool(got[f"psum_{dtype}_alike_rank{r}"])
        _close(got[f"psum_{dtype}_rank{r}"], jx[f"psum_{dtype}"][r], 1e-5)
    xs = _psum_inputs()
    plain = xs.sum(0)
    # int8 in groups of 256: each rank's value within half its group's scale
    assert np.abs(got[f"psum_{dtype}_rank0"] - plain).max() <= \
        WORLD * np.abs(xs).max() / 127 / 2 + (0.05 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("what,tol", [("pipe_out", 1e-5), ("pipe_grad_W", 1e-4),
                                      ("pipe_grad_b", 1e-4)])
def test_pipeline_matches_jax(results, what, tol):
    got, jx = results[:2]
    assert np.abs(got[what] - jx[what]).max() < tol


def test_resume_on_a_mesh_continues_exactly(results):
    got = results[0]
    first, resumed, at, rank = got["resume_counts"]
    assert (first, resumed, at, rank) == (3, 2, 5, 0)
    straight, joined = got["resume_losses"]
    np.testing.assert_allclose(joined, straight, rtol=0, atol=1e-6)


def test_launcher_trains_on_the_debug_mesh_under_torchrun(results):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh
    debug``: 3 steps on the CPU; rank 0 checkpoints and alone prints."""
    stdout = results[2]
    summary = json.loads(stdout[stdout.index("{"):])
    assert summary["steps"] == 3 and np.isfinite(summary["last_loss"])
    assert summary["nvcache"]["nvmm_stored_bytes"] > 0, summary["nvcache"]


MESH_CHECK_PARTS = ["llama3.2-1b train + serve", "mamba2-780m serve", "hymba-1.5b serve",
                    "compressed_psum on 4 ranks", "pipeline on 4 ranks"]


@pytest.mark.parametrize("part", MESH_CHECK_PARTS)
def test_mesh_check_passes_on_the_cpu(results, part):
    """chip_smoke.py phase 7 on the CPU: the 1x1 checks at SMOKE size (the
    sharded step equals the unsharded one: on one rank the same
    arithmetic, and so do the served logits) and the four-rank parts over
    gloo."""
    res = results[3][MESH_CHECK_PARTS.index(part)]
    assert res["failed"] == [], res
    if "4 ranks" in part:
        assert len(res["ranks"]) == WORLD
        return
    assert res["serve_worst_rel"] == 0.0
    if "train" in part:
        assert res["loss_diff"] == 0.0 and res["param_max_diff"] == 0.0
        assert res["grad_worst_rel"] == 0.0 and res["rerun_grad_worst_rel"] == 0.0
