"""The SSM models' sharded train step on four gloo processes on the CPU,
mesh ("data", "model") = (2, 2): mamba2-780m and hymba-1.5b SMOKE against
the unsharded port and against the JAX package's own sharded step.

One job of four ranks (``_job``) runs every case once and rank 0 writes the
results to a file; one subprocess with four fake XLA devices draws JAX's
parameters (the ranks read them back through ``repro_torch.convert``) and
runs JAX's sharded step on a (2, 2) mesh of ``Auto`` axes; one more
process runs ``launch/mesh_check.py``'s 1x1 train part for mamba2 SMOKE.
The job is built as ``tests/test_torch_mesh.py``'s (whose train and resume
cases it reuses): each rank joins through a ``FileStore`` under the test's
temporary directory, and every process is bounded by TIMEOUT.

``ops.ssd`` runs the scan on each rank's shard through ``local_map``.
There A is replicated over ``data`` while x's batch rows split over it,
and B and C are replicated over ``model`` while x's heads split over it;
each rank's dA, dB and dC are then its own shard's share of a sum over
those ranks.  Until they were declared ``Partial()`` there
(``in_grad_placements``), DTensor took one rank's share for the whole: the
float32 sharded step's worst leaf read 1.256 (mamba2-780m, ``ssm/conv_b``)
and 0.943 (hymba-1.5b, ``ssm/A_log``) in max|Δ| / max|ref| against the
unsharded one, every hymba leaf above 1e-3, while the losses agreed to
the last digit; JAX's own sharded step sat at 1.6e-6 and 2.4e-6 of its
unsharded one.

Tolerances: the sharded bf16 step under ``tests/test_sharding.py``'s
bounds (loss 2e-2, parameters 2·lr + 1e-4), as llama's; the float32
step's gradient, read from the first moment, leaf by leaf within
1e-4·(max|ref| + |ref|) of the unsharded port's, compressed also within
one int8 step of the leaf, max|ref| / 127 (``tests/test_torch_mesh.py``'s
bounds); against JAX's sharded step from the same parameters, loss and
gradients within 1e-4·(1 + |ref|), the float32 bound that the unsharded
SSM steps meet against JAX (``tests/test_torch_train.py``: 1e-4, measured
3.1e-6 for mamba2); ``ops.ssd``'s five gradients on DTensors within
1e-5·(1 + |ref|) of autograd of the same call on whole tensors (float32,
sums in another order over shards).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh import LR, TIMEOUT, WORLD, _env, _np, _resume_case, _t, \
    _train_step_cases, _wait

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-780m", "hymba-1.5b")
TOKENS = (4, 32)        # (batch, seq) of every step here, from seed 3
# ops.ssd's cases: x (b, s, h, p), B and C (b, s, g, n), chunk 16
SSD = dict(b=4, s=32, h=4, p=8, g=1, n=8, chunk=16)
SSD_PLACEMENTS = {"batch_over_data": ("Shard(0)", "Replicate()"),
                  "heads_over_model": ("Replicate()", "Shard(2)"),
                  "both": ("Shard(0)", "Shard(2)")}
SSD_GRADS = ("x", "dt", "A", "B", "C")


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, TOKENS)


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict, keys sorted (``checkpoint.manager.
    flatten``'s keys), for either package's trees."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ------------------------------------------------------------ the torch job

def _ssd_inputs():
    rng = np.random.default_rng(11)
    b, s, h, p, g, n = (SSD[k] for k in "bshpgn")
    return {"x": rng.standard_normal((b, s, h, p)), "dt": rng.uniform(0.01, 0.5, (b, s, h)),
            "A": -rng.uniform(0.5, 2.0, h), "B": rng.standard_normal((b, s, g, n)),
            "C": rng.standard_normal((b, s, g, n)), "dy": rng.standard_normal((b, s, h, p)),
            "dstate": rng.standard_normal((b, h, p, n))}


def _ssd_grad_cases(mesh, res):
    """dx, ddt, dA, dB and dC of ``ops.ssd`` on DTensors in the three
    placements ``constrain`` gives the scan, against autograd of the same
    call on whole tensors; the cotangents of y and of the final state are
    placed as the outputs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    arrays = {k: _t(v.astype(np.float32)) for k, v in _ssd_inputs().items()}
    names = SSD_GRADS
    whole = [arrays[k].clone().requires_grad_(True) for k in names]
    y, state = ops.ssd(*whole, chunk=SSD["chunk"])
    want = torch.autograd.grad((y * arrays["dy"]).sum() + (state * arrays["dstate"]).sum(),
                               whole)
    parse = {"Shard(0)": Shard(0), "Shard(2)": Shard(2), "Replicate()": Replicate()}
    for case, pl in SSD_PLACEMENTS.items():
        xpl = [parse[p] for p in pl]
        apl = [Shard(0) if p == Shard(2) else Replicate() for p in xpl]
        bpl = [Shard(0) if p == Shard(0) else Replicate() for p in xpl]
        places = {"x": xpl, "dt": xpl, "A": apl, "B": bpl, "C": bpl}
        leaves = [distribute_tensor(arrays[k], mesh, places[k], src_data_rank=None)
                  .requires_grad_(True) for k in names]
        y, state = ops.ssd(*leaves, chunk=SSD["chunk"])
        dy = distribute_tensor(arrays["dy"], mesh, y.placements, src_data_rank=None)
        ds = distribute_tensor(arrays["dstate"], mesh, state.placements, src_data_rank=None)
        got = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), leaves)
        for name, w, g in zip(names, want, got):
            res[f"ssd_{case}_{name}"] = np.stack([_np(w), _np(g)])
        res[f"ssd_{case}_grad_placements"] = np.array([str(tuple(g.placements)) for g in got])


def _ssd_refusal_case(mesh, res):
    """B and C in two groups with the heads split over ``model``: refused.
    With the heads whole on each rank the same call runs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(12)
    x, dt = torch.randn(4, 16, 4, 8, generator=gen), torch.rand(4, 16, 4, generator=gen)
    A, B, C = -torch.rand(4, generator=gen), *torch.randn(2, 4, 16, 2, 8, generator=gen)

    def call(heads):
        xpl = [Shard(0), Shard(2) if heads else Replicate()]
        place = lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None)  # noqa: E731
        return ops.ssd(place(x, xpl), place(dt, xpl),
                       place(A, [Replicate(), Shard(0) if heads else Replicate()]),
                       place(B, [Shard(0), Replicate()]), place(C, [Shard(0), Replicate()]),
                       chunk=8)

    try:
        call(True)
        res["refuses_ssd_groups_over_split_heads"] = np.array("accepted")
    except ValueError as exc:
        res["refuses_ssd_groups_over_split_heads"] = np.array(str(exc))
    res["ssd_groups_whole_heads"] = np.stack([_np(ops.ssd(x, dt, A, B, C, chunk=8)[0]),
                                              _np(call(False)[0])])


def _ssd_placements_seen(seen):
    """``ops.ssd`` wrapped to add each DTensor call's x placements to
    ``seen`` (the models call it through the module); returns the undo."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import ops
    plain = ops.ssd

    def spy(x, *args, **kwargs):
        if isinstance(x, DTensor):
            seen.add(str(tuple(x.placements)))
        return plain(x, *args, **kwargs)

    ops.ssd = spy
    return lambda: setattr(ops, "ssd", plain)


def _train_cases(mesh, res):
    """Each arch's train step cases (``test_torch_mesh._train_step_cases``),
    with the placements x met the scan in."""
    for arch in ARCHS:
        seen = set()
        undo = _ssd_placements_seen(seen)
        try:
            _train_step_cases(mesh, res, arch, prefix=f"{arch}_")
        finally:
            undo()
        res[f"{arch}_ssd_placements"] = np.array(sorted(seen))


def _jax_params(path):
    """The JAX subprocess's parameters, once it has written them."""
    from repro_torch.checkpoint.manager import unflatten
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX parameters at {path}")
        time.sleep(0.2)
    with np.load(path) as f:
        flat = dict(f)
    return {arch: unflatten([(k.split("|", 1)[1], v) for k, v in flat.items()
                             if k.startswith(arch + "|")]) for arch in ARCHS}


def _from_jax_case(mesh, res, params_path):
    """The float32 sharded step from JAX's parameters: the gradient it
    applied, read from the first moment, and its loss."""
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs.registry import get_smoke
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.registry import build
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as tsteps
    params = _jax_params(params_path)
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        model, opt = build(cfg), AdamW(lr=LR)
        p = params_from_numpy(params[arch], "cpu")
        state = {"params": p, "opt": opt.init(p)}
        batch = {"tokens": _t(_tokens(cfg.vocab))}
        (placed, bplaced), _ = tsteps.train_shardings(model, opt, mesh, batch)
        sstate = shd.distribute(state, mesh, placed, src_data_rank=None)
        metrics = tsteps.bind_mesh(tsteps.make_train_step(model, opt), mesh)(
            sstate, shd.distribute(batch, mesh, bplaced, src_data_rank=None))
        res[f"jax_{arch}|loss"] = np.array(float(metrics["loss"]))
        for key, m in flatten(shd.full(sstate)["opt"]["m"]):
            res[f"jax_{arch}|{key}"] = _np(m) / (1 - opt.b1)


def _job(rank, store, out, params_path):
    """One rank of the job: every case, rank 0 writes the results."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    init_distributed(device_type="cpu", store_path=store, rank=rank, world_size=WORLD)
    mesh = make_debug_mesh(device_type="cpu")
    res = {}
    _ssd_grad_cases(mesh, res)
    _ssd_refusal_case(mesh, res)
    _train_cases(mesh, res)
    _resume_case(mesh, res, "mamba2-780m", prefix="mamba2-780m_")
    _from_jax_case(mesh, res, params_path)
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


# --------------------------------------------------------------- JAX side

JAX_SUBPROC = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, {tests!r})
    import test_torch_mesh_ssm as t
    from repro.configs.registry import get_smoke
    from repro.models.registry import build
    from repro.optim.adamw import AdamW
    from repro.train import steps as tsteps

    params_out, grads_out = sys.argv[1], sys.argv[2]
    cfgs = {{a: dataclasses.replace(get_smoke(a), compute_dtype="float32") for a in t.ARCHS}}
    params = {{a: jax.tree.map(np.asarray, build(c).init(jax.random.PRNGKey(0)))
              for a, c in cfgs.items()}}
    # the ranks wait for the parameters: written whole, then renamed
    np.savez(params_out + ".part.npz", **{{f"{{a}}|{{k}}": v for a, p in params.items()
                                          for k, v in t._flat(p).items()}})
    os.replace(params_out + ".part.npz", params_out)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    res = {{}}
    for arch, cfg in cfgs.items():
        model, opt = build(cfg), AdamW(lr=t.LR)
        batch = {{"tokens": jnp.asarray(t._tokens(cfg.vocab), jnp.int32)}}
        state = {{"params": params[arch], "opt": opt.init(params[arch])}}
        with mesh:
            step = tsteps.bind_mesh(tsteps.make_train_step(model, opt), mesh)
            (in_sh, b_sh), (out_sh, _), _ = tsteps.train_shardings(model, opt, mesh, batch)
            new, metrics = jax.jit(step, in_shardings=(in_sh, b_sh),
                                   out_shardings=(out_sh, None))(state, batch)
        res[f"{{arch}}|loss"] = np.asarray(metrics["loss"])
        for k, m in t._flat(jax.tree.map(np.asarray, new["opt"]["m"])).items():
            res[f"{{arch}}|{{k}}"] = m / (1 - opt.b1)
    np.savez(grads_out, **res)
""")

# launch/mesh_check.py's 1x1 train part for mamba2 SMOKE on the CPU: one
# process, the 1x1 mesh over gloo (chip_smoke.py phase 7 runs it at full
# width on the card)
MESH_CHECK = textwrap.dedent("""
    import json, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch import mesh_check
    print(json.dumps(mesh_check.single_mesh(get_smoke("mamba2-780m"), device="cpu", batch=2,
                                            seq=64, lr=1e-3)))
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(torch results, JAX results, mesh_check's 1x1 part): the four-rank
    job, the JAX subprocess and the check, run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_ssm")
    store, out = tmp / "store", tmp / "torch.npz"
    jparams, jout = tmp / "jax_params.npz", tmp / "jax.npz"
    env = _env()

    def start(*args):
        return subprocess.Popen([sys.executable, *args], env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    jax_proc = start("-c", JAX_SUBPROC.format(tests=str(ROOT / "tests")), str(jparams),
                     str(jout))
    ranks = [start("-c", f"import test_torch_mesh_ssm as t; t._job({r}, {str(store)!r}, "
                         f"{str(out)!r}, {str(jparams)!r})") for r in range(WORLD)]
    checker = start("-c", MESH_CHECK)
    _wait([jax_proc], "the JAX reference")
    _wait(ranks, "the four-rank job")
    (_, checked, _), = _wait([checker], "launch/mesh_check.py on the CPU")
    return dict(np.load(out)), dict(np.load(jout)), json.loads(checked.strip().splitlines()[-1])


# ------------------------------------------------------------------- tests

def _leaves(got, key):
    want, have = got[key]
    cuts = np.cumsum(got[f"{key}_sizes"])[:-1]
    return zip(got[f"{key}_names"], np.split(want, cuts), np.split(have, cuts))


@pytest.mark.parametrize("kind", ["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_ssm_step_within_jax_bounds(results, arch, kind):
    got = results[0]
    loss = got[f"{arch}_step_{kind}_loss"]
    assert abs(loss[0] - loss[1]) < 2e-2, loss
    assert float(got[f"{arch}_step_{kind}_param_delta"]) <= 2 * LR + 1e-4
    assert bool(got[f"{arch}_step_{kind}_placements_kept"])
    assert int(got[f"{arch}_step_{kind}_sharded_leaves"]) > 0


@pytest.mark.parametrize("kind", ["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_ssm_step_gradients_match_unsharded(results, arch, kind):
    """The gradient each float32 step applied, sharded against unsharded,
    leaf by leaf (compressed: each side rounds to its own int8 groups, a
    shard's against the whole leaf's, so also one int8 step of the leaf).
    Before ``ops.ssd`` declared its partial sums this read 0.94-1.26."""
    got = results[0]
    for name, w, h in _leaves(got, f"{arch}_grad_{kind}"):
        top = np.abs(w).max()
        assert top > 0, name
        rounding = top / 127 if kind == "compressed" else 0.0
        assert np.all(np.abs(h - w) <= rounding + 1e-4 * (top + np.abs(w))), \
            (name, float(np.abs(h - w).max() / top))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_scan_runs_on_split_heads_and_batch(results, arch):
    """The sharded steps met ``ops.ssd`` with x's batch over ``data`` and
    its heads over ``model``, so each rank's dA, dB and dC were partial;
    the weights shard by FSDP and the embedding over ``model`` too."""
    got = results[0]
    assert "(Shard(dim=0), Shard(dim=2))" in set(got[f"{arch}_ssd_placements"])
    names = got[f"{arch}_grad_plain_names"]
    sharded = set(names[got[f"{arch}_grad_plain_sharded"]])
    assert {"embed", "layers/ssm/in_proj", "layers/ssm/out_proj"} <= sharded, sharded
    assert "layers/ssm/A_log" not in sharded


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_ssm_step_matches_jax_sharded_step(results, arch):
    """The port's sharded float32 step against JAX's sharded step on four
    fake devices, both from JAX's parameters: loss and every leaf's
    gradient (the first moment over 1 - b1) within 1e-4·(1 + |ref|)."""
    got, jx = results[:2]
    loss, want = float(got[f"jax_{arch}|loss"]), float(jx[f"{arch}|loss"])
    assert abs(loss - want) <= 1e-4 * (1 + abs(want)), (loss, want)
    keys = sorted(k for k in jx if k.startswith(arch + "|") and k != f"{arch}|loss")
    assert keys == sorted(k.removeprefix("jax_") for k in got
                          if k.startswith(f"jax_{arch}|") and not k.endswith("|loss"))
    for key in keys:
        g, w = got["jax_" + key], jx[key]
        assert g.shape == w.shape, key
        assert np.abs(w).max() > 0, key
        assert np.all(np.abs(g - w) <= 1e-4 * (1 + np.abs(w))), \
            (key, float(np.abs(g - w).max()))


@pytest.mark.parametrize("name", SSD_GRADS)
@pytest.mark.parametrize("case", SSD_PLACEMENTS)
def test_ssd_gradients_on_dtensors_match_whole_tensors(results, case, name):
    want, got = results[0][f"ssd_{case}_{name}"]
    assert np.abs(want).max() > 0
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want))), \
        float(np.abs(got - want).max())


def test_ssd_refuses_groups_over_split_heads(results):
    said = str(results[0]["refuses_ssd_groups_over_split_heads"])
    assert said.startswith("ops:") and "g = 2" in said, said
    want, got = results[0]["ssd_groups_whole_heads"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ssm_resume_on_a_mesh_continues_exactly(results):
    """``train_loop.train(..., mesh=mesh)`` for mamba2 SMOKE through NVCache,
    the path of ``launch/train.py --arch mamba2-780m --smoke --mesh debug``:
    5 steps straight equal 3, a checkpoint, and a resume to 5."""
    got = results[0]
    first, resumed, at, rank = got["mamba2-780m_resume_counts"]
    assert (first, resumed, at, rank) == (3, 2, 5, 0)
    straight, joined = got["mamba2-780m_resume_losses"]
    np.testing.assert_allclose(joined, straight, rtol=0, atol=1e-6)


def test_mesh_check_trains_mamba2_on_the_1x1_mesh(results):
    """``launch/mesh_check.py``'s SSM train part at SMOKE size on the CPU:
    on one rank the sharded step is the unsharded one's arithmetic."""
    res = results[2]
    assert res["failed"] == [] and res["arch"] == "mamba2-780m-smoke", res
    assert res["loss_diff"] == 0.0 and res["param_max_diff"] == 0.0
    assert res["grad_worst_rel"] == 0.0 and res["rerun_grad_worst_rel"] == 0.0
    assert "serve_ok" not in res    # ssm_serve serves it
