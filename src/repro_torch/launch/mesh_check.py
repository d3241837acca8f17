"""The mesh path on the card: phase 7 of ``chip_smoke.py``, also runnable
alone on a machine with a CUDA card:

    python -m repro_torch.launch.mesh_check

(a) ``make_single_mesh()``'s 1x1 mesh on NCCL at full width: llama3.2-1b's
    train step (4 x 2048 tokens, remat "dots", AdamW, int8-compressed
    gradients) through ``train_shardings`` and ``bind_mesh`` against the
    unsharded step on the same state and batch, the two timed in turns; then
    a prefill of 4 x 2048 and 8 decode steps through ``serve_shardings``
    against the unsharded path; then mamba2-780m's train step the same way
    (K3 and its backward on the rank's heads through ``kernels/ops.py``'s
    ``local_map``; ``ssm_serve`` serves it).  On one rank each shard is the
    whole tensor, so the sharded state is a set of DTensor views of the
    unsharded one (``DTensor.from_local``): one copy of the 14.8 GB state
    in memory.  A size-1 axis's partial sum is already whole, so this part
    cannot show ``ops.ssd``'s summed dA, dB and dC: the four gloo ranks on
    the CPU do (``tests/test_torch_mesh_ssm.py``).
(b) Four processes on the one card over ``gloo`` (NCCL refuses two ranks
    on one device): ``compressed_psum`` and the GPipe schedule, each against
    the same computation on one rank.  Only these two: torch 2.11's gloo
    takes neither send/recv nor the functional all-gather under DTensor's
    redistributes on CUDA tensors (PERF.md), while these two need only
    ``all_gather_into_tensor``, ``all_to_all_single`` and ``all_reduce``.

Prints one JSON line a part.  Kernel launches are read off the wrappers'
counters (``kernels/flash_attention.py``, ``kernels/quantize.py``,
``kernels/ssd_scan.py``).
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LR = 1e-5               # chip_smoke.py's TRAIN_LR: Adam at d_model 2048
B, S = 4, 2048          # chip_smoke.py's phase 5 and serving shapes
DECODE_STEPS = 8
TURNS = 3               # timed (unsharded, sharded) pairs, the order alternating
# the JAX test's bounds for a sharded step against the unsharded one
# (tests/test_sharding.py::test_pjit_8dev_matches_single_device): loss 2e-2,
# parameters 2·lr + 1e-4 (Adam's first step moves each by ±lr, the sign set
# by sums in another order); logits 2e-2·(1+|ref|) in bf16
LOSS_TOL = 2e-2
LOGIT_TOL = 2e-2
# those bounds pass any gradient, so the gradient each step applied (its
# first moment) is held leaf by leaf, as its largest gap over its largest
# |m|: the step int8-compresses the gradient, so a gradient a hair off can
# round to the next int8 step, 1/127 of its group's largest |g|, and the
# rest is the raw gradients' own gap (the K1 backward's dq adds with
# atomics).  On the H100 the unsharded step against itself read 8.9e-3 and
# the sharded one against it 9.6e-3; a dropped or zero gradient reads 1
GRAD_TOL = 1 / 127 + 1e-2
# The SSM families' backward is noisier: K3's backward adds dB, dC, dA and
# ddt with fp32 atomics, and 48 bf16 layers of random weights carry a
# last-bit change back to 0.2-6.5% of a leaf's largest |m| (mamba2-780m at
# 4 x 2048 on the H100, the unsharded step against itself: 9 of its 11
# leaves above GRAD_TOL).  The sharded step is one more draw of that noise,
# so there each leaf is held to NOISE_HELD times the unsharded step's worst
# run-to-run gap over NOISE_RERUNS reruns, as phase 4 of chip_smoke.py holds
# bf16 decodes to their noise (six draws on the H100: the sharded worst leaf
# at 0.75-1.30x one rerun's worst); a noise above NOISE_CAP / NOISE_HELD (a
# bound that would pass a dropped gradient, which reads 1) fails
NOISE_HELD = 2
NOISE_RERUNS = 2
NOISE_CAP = 0.5
WORLD = 4
# each four-rank part's processes are killed after RANKS_TIMEOUT; a
# collective that waits on a peer gives up after OP_TIMEOUT (gloo's own
# timeout), so a hung op ends the part early
RANKS_TIMEOUT = 120
OP_TIMEOUT = datetime.timedelta(seconds=30)


def _kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import ssd_scan as ssd
    return {"k1": fa.flash_attention_cuda, "k1b": fa.flash_attention_bwd_cuda,
            "k2": quant.quantize_cuda, "k3": ssd.ssd_cuda, "k3b": ssd.ssd_bwd_cuda}


def launches():
    return {k: fn.launches for k, fn in _kernels().items()}


def zero_launches():
    """Every counter to 0: each run of the mesh path is read from 0, so its
    counts hold no launch of the unsharded runs it is compared with."""
    for fn in _kernels().values():
        fn.launches = 0


def train_launches(cfg, n_leaves: int) -> dict:
    """One train step's launches for a decoder-only ``cfg``: K1 in each
    layer with attention and K3 in each layer with an SSM, once in the
    forward and once more where remat recomputes the layer, their backwards
    once a layer; K2 once a gradient leaf (``n_leaves``)."""
    passes = 1 if cfg.remat == "none" else 2
    attn, ssm = cfg.attn_kind != "none", cfg.family in ("ssm", "hybrid")
    return {"k1": passes * cfg.n_layers * attn, "k1b": cfg.n_layers * attn, "k2": n_leaves,
            "k3": passes * cfg.n_layers * ssm, "k3b": cfg.n_layers * ssm}


def _on_one_route(routes) -> bool:
    """Every launch of a kernel on its ``wgmma`` route, and at least one."""
    return routes["wgmma"] > 0 and routes["wgmma"] == sum(routes.values())


def _add(total, counts):
    return {k: total.get(k, 0) + n for k, n in counts.items()}


def _views(tree, mesh, placed):
    """``tree``'s tensors as DTensors placed by ``placed`` on a mesh of one
    rank, where a shard is the whole tensor: views, no copy."""
    from torch.distributed.tensor import DTensor
    return {k: _views(v, mesh, placed[k]) if isinstance(v, dict)
            else DTensor.from_local(v, mesh, placed[k], run_check=False)
            for k, v in tree.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn, *args):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    float(out["loss"])
    _sync(dev)
    return out, time.perf_counter() - t0


def single_mesh(cfg=None, *, device="cuda", batch=B, seq=S, lr=LR) -> dict:
    """Part (a): the train step and serving on the 1x1 mesh against the
    unsharded path, for ``cfg`` (default llama3.2-1b at full width) at
    ``batch`` x ``seq``; an SSM or hybrid ``cfg`` trains only (``ssm_serve``
    serves it).  The unsharded step runs twice from the same state (its
    run-to-run gap: on the card the K1 backward's dq and K3's backward's
    dB, dC, dA and ddt add with atomics, so no two backward passes are
    bit-equal) and the sharded step once; the gradient each applied is read
    from its first moment (an SSM or hybrid ``cfg`` reruns the unsharded
    step NOISE_RERUNS times and is held to NOISE_HELD times its gap); then
    TURNS warm (unsharded, sharded) pairs are timed.  Returns the numbers
    and, under "failed", the checks that missed (the launch and route
    checks on the card only: every K1 and K3 backward launch on its
    ``wgmma`` route)."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_single_mesh
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import steps as tsteps

    dev = torch.device(device)
    mesh = make_single_mesh(device_type=dev.type)
    cfg = cfg or get_config("llama3.2-1b")
    model, opt = build(cfg), AdamW(lr=lr)
    out = {"arch": cfg.arch, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend()}
    state = tsteps.init_train_state(model, opt, torch.Generator(dev).manual_seed(0))
    tokens = {"tokens": torch.from_numpy(
        SyntheticTokens(cfg.vocab, batch, seq, seed=0).next()["tokens"]).to(dev)}
    host = {k: t.to("cpu", copy=True) for k, t in flatten(state["params"])}
    step = tsteps.make_train_step(model, opt, compress=True)

    def restore():
        for k, t in flatten(state["params"]):
            t.copy_(host[k])
        for part in ("m", "v"):
            for _, t in flatten(state["opt"][part]):
                t.zero_()
        state["opt"]["step"].zero_()

    def gaps():
        """(largest parameter gap, each leaf's largest first-moment gap
        over its largest |m|) of ``state`` against the first step's."""
        params = max(float((t.float() - ref_params[k].float()).abs().max())
                     for k, t in flatten(state["params"]))
        moments = {k: float((t.float() - ref_m[k].float()).abs().max()
                            / ref_m[k].float().abs().max())
                   for k, t in flatten(state["opt"]["m"])}
        return params, moments

    zero_launches()
    ref, out["unsharded_first_s"] = _timed(dev, step, state, tokens)
    out["launches_unsharded"] = launches()
    ref_params = {k: t.clone() for k, t in flatten(state["params"])}
    ref_m = {k: t.clone() for k, t in flatten(state["opt"]["m"])}
    ssm = cfg.family in ("ssm", "hybrid")     # trains only; noise-held gradients
    out["rerun_param_max_diff"], out["rerun_grad_rel"] = 0.0, {}
    for _ in range(NOISE_RERUNS if ssm else 1):
        restore()
        step(state, tokens)
        params, moments = gaps()
        out["rerun_param_max_diff"] = max(out["rerun_param_max_diff"], params)
        out["rerun_grad_rel"] = {k: max(v, out["rerun_grad_rel"].get(k, 0.0))
                                 for k, v in moments.items()}
    out["rerun_grad_worst_rel"] = max(out["rerun_grad_rel"].values())
    restore()
    del host

    (placed, bplaced), _ = tsteps.train_shardings(model, opt, mesh, tokens)
    sstate = _views(state, mesh, placed)
    sbatch = _views(tokens, mesh, bplaced)
    sstep = tsteps.bind_mesh(step, mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_cuda.routes = dict.fromkeys(fa.ROUTES, 0)
    ssd.ssd_cuda.routes = dict.fromkeys(ssd.ROUTES, 0)
    ssd.ssd_bwd_cuda.routes = dict.fromkeys(ssd.ROUTES, 0)
    zero_launches()
    got, out["sharded_first_s"] = _timed(dev, sstep, sstate, sbatch)
    out["launches_sharded"] = launches()
    out["k1_routes"] = dict(fa.flash_attention_cuda.routes)
    out["k3_routes"] = dict(ssd.ssd_cuda.routes)
    out["k3b_routes"] = dict(ssd.ssd_bwd_cuda.routes)
    if dev.type == "cuda":
        out["peak_gib_sharded"] = torch.cuda.max_memory_allocated() / 2**30
    out["loss_unsharded"], out["loss_sharded"] = float(ref["loss"]), float(got["loss"])
    out["loss_diff"] = abs(out["loss_unsharded"] - out["loss_sharded"])
    out["param_max_diff"], out["grad_rel"] = gaps()
    out["grad_worst_rel"] = max(out["grad_rel"].values())
    out["placements_kept"] = all(
        tuple(t.placements) == tuple(pl) for (_, t), (_, pl) in
        zip(flatten(sstate), flatten(placed)))
    del ref_params, ref_m

    times = {"unsharded": [], "sharded": []}
    for i in range(TURNS):
        order = (("unsharded", step, state, tokens), ("sharded", sstep, sstate, sbatch))
        for name, fn, st, bt in (order if i % 2 == 0 else order[::-1]):
            times[name].append(_timed(dev, fn, st, bt)[1])
    out["warm_ms"] = {k: [t * 1e3 for t in v] for k, v in times.items()}
    mean = {k: sum(v) / len(v) * 1e3 for k, v in times.items()}
    out["warm_mean_ms"] = mean
    out["dispatch_overhead_ms"] = mean["sharded"] - mean["unsharded"]

    if not ssm:
        out.update(_serve(model, mesh, state["params"], sstate["params"], dev, batch, seq))
    del state, sstate
    failed = []
    if dev.type == "cuda":
        want = train_launches(cfg, len(flatten(placed["params"])))
        out["launches_wanted"] = want
        if out["launches_sharded"] != want or out["launches_unsharded"] != want:
            failed.append("launches")
        for key in ("k1", "k3b"):
            if want[key] and not _on_one_route(out[f"{key}_routes"]):
                failed.append(f"{key} route")
        if not ssm and out["serve_launches"]["k1"] != cfg.n_layers:
            failed.append("serve launches")
    if not out["loss_diff"] < LOSS_TOL:
        failed.append("loss")
    if not out["param_max_diff"] <= 2 * lr + 1e-4:
        failed.append("parameters")
    out["grad_tol"] = NOISE_HELD * out["rerun_grad_worst_rel"] if ssm else GRAD_TOL
    if not out["grad_worst_rel"] <= out["grad_tol"] <= NOISE_CAP:
        failed.append("gradients")
    if not out["placements_kept"]:
        failed.append("placements")
    if not ssm and not out["serve_ok"]:
        failed.append("serve")
    out["failed"] = failed
    return out


def ssm_serve(cfg=None, *, device="cuda", batch=B, seq=S) -> dict:
    """mamba2-780m (default, full width) served on the 1x1 mesh against the
    unsharded path: K3 runs on the rank's heads through ``kernels/ops.py``'s
    ``local_map``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_single_mesh
    from repro_torch.models.registry import build
    dev = torch.device(device)
    mesh = make_single_mesh(device_type=dev.type)
    cfg = cfg or get_config("mamba2-780m")
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    placed, _ = _serve_shardings(model, mesh, batch, seq)
    ssd.ssd_cuda.routes = dict.fromkeys(ssd.ROUTES, 0)
    out = {"arch": cfg.arch, **_serve(model, mesh, params, _views(params, mesh, placed["params"]),
                                      dev, batch, seq)}
    out["k3_routes"] = dict(ssd.ssd_cuda.routes)
    failed = [] if out["serve_ok"] else ["serve"]
    if dev.type == "cuda":
        if out["serve_launches"]["k3"] != cfg.n_layers:
            failed.append("serve launches")
        if not _on_one_route(out["k3_routes"]):
            failed.append("k3 route")
    out["failed"] = failed
    return out


def _serve_shardings(model, mesh, batch, seq):
    from repro_torch.train import steps as tsteps
    max_len = seq + DECODE_STEPS
    like = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta")}
    return tsteps.serve_shardings(model, mesh, model.init_cache(batch, max_len, "meta"), like)


def _serve(model, mesh, params, sparams, dev, batch, seq) -> dict:
    """A prefill of batch x seq and DECODE_STEPS teacher-forced decode
    steps, unsharded and through ``serve_shardings`` on ``mesh``: the
    logits held to LOGIT_TOL·(1+|ref|)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train import steps as tsteps
    cfg = model.cfg
    max_len = seq + DECODE_STEPS
    tokens = torch.from_numpy(
        SyntheticTokens(cfg.vocab, batch, max_len, seed=1).next()["tokens"]).to(dev)
    prompt = {"tokens": tokens[:, :seq].contiguous()}
    placed, _ = _serve_shardings(model, mesh, batch, seq)
    prefill = tsteps.make_prefill_step(model, max_len)
    decode = tsteps.make_serve_step(model)
    sprefill, sdecode = tsteps.bind_mesh(prefill, mesh), tsteps.bind_mesh(decode, mesh)
    worst = 0.0
    with torch.no_grad():
        want, cache = prefill(params, prompt)
        zero_launches()
        got, scache = sprefill(sparams, _views(prompt, mesh, placed["batch"]))
        counts = launches()
        pairs = [(want, got)]
        for i in range(seq, max_len):
            t = tokens[:, i:i + 1].contiguous()
            want, cache = decode(params, cache, t)
            zero_launches()
            got, scache = sdecode(sparams, scache, _views({"t": t}, mesh,
                                                          {"t": placed["batch"]["tokens"]})["t"])
            counts = _add(counts, launches())
            pairs.append((want, got))
        for w, g in pairs:
            g = g.full_tensor()
            worst = max(worst, float(((g - w).abs() / (1 + w.abs())).max()))
        finite = all(bool(torch.isfinite(g.full_tensor()).all()) for _, g in pairs)
    return {"serve_launches": counts, "serve_worst_rel": worst,
            "serve_ok": finite and worst <= LOGIT_TOL,
            "serve_cache_placements": {k: str(tuple(v.placements)) for k, v in scache.items()}}


# ------------------------------------------------------- (b) four ranks

def _join(rank, store, device_type):
    """Join the four-rank gloo group; returns the rank's device (on one
    card, every rank's)."""
    from repro_torch.launch.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("gloo", device_type=device_type, store_path=store, rank=rank,
                     world_size=WORLD, timeout=OP_TIMEOUT)
    return (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
            else torch.device("cpu"))


PSUM_SHAPE = (1024, 1024)   # a gradient leaf's worth: 1 M values a rank
PSUM_TOL = 1e-5             # tests/test_torch_mesh.py's bound against JAX


def _psum_rank(rank, store, out_dir, device_type):
    """One of part (b)'s ranks: ``compressed_psum`` of its own seeded tensor
    over gloo, in float32 and bfloat16; rank 0 also computes the same sum
    on its own (K2 on each rank's tensor, dequantized and summed in rank
    order) and writes both results' largest gap and each rank's K2
    launches."""
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.grad_compress import compressed_psum
    res = {}
    try:
        dev = _join(rank, store, device_type)
        xs = [torch.randn(PSUM_SHAPE, generator=torch.Generator().manual_seed(r)).to(dev)
              for r in range(WORLD)]
        for dtype in (torch.float32, torch.bfloat16):
            before = launches()["k2"]
            got = compressed_psum(xs[rank].to(dtype), dist.group.WORLD)
            res[f"k2_launches_{dtype}"] = launches()["k2"] - before
            alike = [torch.empty_like(got) for _ in range(WORLD)]
            dist.all_gather(alike, got)
            res[f"alike_{dtype}"] = all(torch.equal(a, got) for a in alike)
            if rank == 0:
                parts = [kops.quantize(x.to(dtype).reshape(-1)) for x in xs]
                want = kops.dequantize(torch.stack([q for q, _ in parts]),
                                       torch.stack([sc for _, sc in parts])).sum(0)
                want = want.reshape(PSUM_SHAPE).to(dtype).float()
                gap = ((got.float() - want).abs() / (1 + want.abs())).max()
                res[f"worst_rel_{dtype}"] = float(gap)
        _sync(dev)
    except Exception:   # reported by the parent
        res["error"] = traceback.format_exc()[-1500:]
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _run_ranks(target, device_type) -> list:
    """``target(rank, store, out_dir, device_type)`` in WORLD spawned
    processes on the one card, bounded by RANKS_TIMEOUT; each rank's JSON
    result, or {"error": ...} where it wrote none."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=target, args=(r, os.path.join(tmp, "store"), tmp, device_type))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        ranks = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            path = os.path.join(tmp, f"{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {"error": f"exit code {p.exitcode}"})
    return ranks


def ranks_psum(device_type="cuda") -> dict:
    """Part (b): ``compressed_psum`` over four gloo ranks on the one card
    (gloo takes ``all_gather_into_tensor`` on CUDA tensors), held to the
    same sum computed on one rank."""
    ranks = _run_ranks(_psum_rank, device_type)
    out = {"ranks": ranks}
    failed = [f"rank {r}: {rk['error']}" for r, rk in enumerate(ranks) if "error" in rk]
    if not failed:
        for dtype in (torch.float32, torch.bfloat16):
            if not all(rk[f"alike_{dtype}"] for rk in ranks):
                failed.append(f"{dtype}: ranks disagree")
            if not ranks[0][f"worst_rel_{dtype}"] <= PSUM_TOL:
                failed.append(f"{dtype}: off the one-rank sum")
            if device_type == "cuda" and any(rk[f"k2_launches_{dtype}"] != 1 for rk in ranks):
                failed.append(f"{dtype}: K2 launches")
    out["failed"] = failed
    return out


# the pipeline case of tests/test_pipeline.py: 8 layers in 4 stages of 2,
# 6 microbatches of 4 rows of 16; its bounds (forward 1e-5, gradients 1e-4)
PIPE = dict(L=8, D=16, M=6, MB=4)


def _pipe_rank(rank, store, out_dir, device_type):
    """One of part (b)'s ranks: ``pipeline_apply`` over a ("stage",) mesh of
    the four ranks, forward and the gradients of sum(out²), against the
    layers applied in sequence on this rank alone."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    res = {}
    try:
        dev = _join(rank, store, device_type)
        L, D, M, MB = PIPE.values()
        gen = torch.Generator().manual_seed(0)
        Ws = (torch.randn((L, D, D), generator=gen) / D ** 0.5).to(dev)
        bs = (torch.randn((L, D), generator=gen) * 0.1).to(dev)
        x = torch.randn((M, MB, D), generator=gen).to(dev)

        def layers(ws, b, h):
            for w, c in zip(ws, b):
                h = torch.tanh(h @ w + c)
            return h

        mesh = init_device_mesh(device_type, (WORLD,), mesh_dim_names=("stage",))
        params = tuple(distribute_tensor(a, mesh, [Shard(0)], src_data_rank=None)
                       .requires_grad_(True) for a in split_stages((Ws, bs), WORLD))
        out = pipeline_apply(mesh, "stage", lambda p, h: layers(*p, h), params, x)
        (out ** 2).sum().backward()

        def whole(grad, like):
            # gloo's all-gather on CUDA tensors (DTensor's full_tensor takes
            # the functional all-gather, which gloo aborts on there)
            parts = torch.empty(WORLD * grad.to_local().numel(), device=dev)
            dist.all_gather_into_tensor(parts, grad.to_local().contiguous().reshape(-1))
            return parts.reshape(like.shape)

        got = [out.to_local(), whole(params[0].grad, Ws), whole(params[1].grad, bs)]
        wref, bref = Ws.clone().requires_grad_(True), bs.clone().requires_grad_(True)
        ref = torch.stack([layers(wref, bref, mb) for mb in x])
        (ref ** 2).sum().backward()
        for name, g, w in zip(("out", "grad_W", "grad_b"), got, (ref, wref.grad, bref.grad)):
            res[name] = float((g - w).detach().abs().max())
        _sync(dev)
    except Exception:   # reported by the parent
        res["error"] = traceback.format_exc()[-1500:]
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def ranks_pipeline(device_type="cuda") -> dict:
    """Part (b): the GPipe schedule over four gloo ranks on the one card
    (its shift is an all-to-all, which gloo takes on CUDA tensors; the final
    sum an all-reduce), held to the layers in sequence on one rank."""
    ranks = _run_ranks(_pipe_rank, device_type)
    failed = [f"rank {r}: {rk['error']}" for r, rk in enumerate(ranks) if "error" in rk]
    if not failed and not all(rk["out"] < 1e-5 and rk["grad_W"] < 1e-4 and rk["grad_b"] < 1e-4
                              for rk in ranks):
        failed.append("off the sequential layers")
    return {"ranks": ranks, "failed": failed}


def main() -> int:
    """Each part in turn, one JSON line each; a part that raises prints its
    traceback and fails the run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import init_distributed
    if not torch.cuda.is_available():
        print("mesh_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    init_distributed(device_type="cuda")
    ok = True
    parts = (("single_mesh", single_mesh), ("ssm_serve", ssm_serve),
             ("ssm_train", lambda: single_mesh(get_config("mamba2-780m"))),
             ("ranks_psum", ranks_psum), ("ranks_pipeline", ranks_pipeline))
    for name, part in parts:
        t0 = time.perf_counter()
        try:
            res = part()
            ok &= not (isinstance(res.get("failed"), list) and res["failed"])
        except Exception:   # report every part
            traceback.print_exc()
            res, ok = "raised", False
        print(json.dumps({name: res, "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
