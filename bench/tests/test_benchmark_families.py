"""Model families (``bench/families/<family>.py``), found by name:

* a family the benchmark has no cell of is added as new files only (the
  port's ``dense`` family at minitron-8b's SMOKE size: a configuration, a
  family module written here from the shared building blocks, a cell
  under each traffic mix), and its cells run ``correct`` and read the
  family's FLOPs;
* the ``ssm`` and ``hybrid`` families give the weights, FLOPs, SSD scans,
  metric readings and SMOKE-size check numbers recorded from the tree
  before they were moved out of the shared modules (commit 4c15929,
  ``recorded_readings.json``);
* a configuration whose family has no module fails at set-up, naming the
  file to add."""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import families, run
from bench.harness import manifest
from bench.reference.weights import draw, flat_items, leaf_specs
from bench.work.flops import forward_flops, train_step_flops
from bench.work.peaks import PEAK_BF16_FLOPS
from conftest import ROOT, smoke_copy

RECORDED = json.loads((Path(__file__).parent / "recorded_readings.json").read_text())
ARCHS = ("mamba2-780m", "hymba-1.5b")
CELLS = sorted(RECORDED["numbers"])

DENSE = '''"""The dense family: GQA attention then a SwiGLU MLP in every layer."""
import math

from bench.reference import model as ref
from bench.reference.weights import lm_specs
from bench.work.flops import attention_pair_flops, gqa_proj_flops, swiglu_flops, unembed_flops


def leaf_specs(m):
    d, L, f = m["d_model"], m["n_layers"], m["d_ff"]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    res = 1.0 / math.sqrt(2 * L)
    return lm_specs(m, {
        "norm1": ((L, d), "ones", 0),
        "attn.wq": ((L, d, H * hd), "normal", d ** -0.5),
        "attn.wk": ((L, d, KV * hd), "normal", d ** -0.5),
        "attn.wv": ((L, d, KV * hd), "normal", d ** -0.5),
        "attn.wo": ((L, H * hd, d), "normal", (H * hd) ** -0.5 * res),
        "norm2": ((L, d), "ones", 0),
        "mlp.wg": ((L, d, f), "normal", d ** -0.5),
        "mlp.wu": ((L, d, f), "normal", d ** -0.5),
        "mlp.wd": ((L, f, d), "normal", f ** -0.5 * res),
    })


def block(m, pl, x, window, mm):
    x = x + ref.attention(m, pl["attn"], ref.rmsnorm(x, pl["norm1"], m["norm_eps"]), window, mm)
    return x + ref.swiglu(pl["mlp"], ref.rmsnorm(x, pl["norm2"], m["norm_eps"]), mm)


def hidden(m, params, tokens, mm=ref.f32_mm, remat=False):
    return ref.decoder(m, params, tokens, block, mm, remat)


def forward_flops(m, B, S, *, unembed_all=True):
    L, tokens = m["n_layers"], B * S
    return (L * (gqa_proj_flops(m, tokens) + swiglu_flops(m, tokens)
                 + attention_pair_flops(m, B, S, 0)) + unembed_flops(m, B, S, unembed_all))


def ssd_scans(m):
    return []
'''


def _smoke_model(arch):
    from repro_torch.configs.registry import get_smoke
    m = dataclasses.asdict(get_smoke(arch))
    return json.loads(json.dumps(m))           # tuples as the JSON file holds them


def _add_dense(root: Path, *, module: bool):
    """minitron-8b's SMOKE model as a configuration ``tiny-dense`` with a
    cell under each traffic mix, and, with ``module``, its family's file."""
    bench = root / "bench"
    conf = json.loads((bench / "configs" / "hymba-1.5b.json").read_text())
    conf.update(name="tiny-dense", source="https://arxiv.org/abs/2407.14679",
                model=_smoke_model("minitron-8b"))
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    if module:
        (bench / "families" / "dense.py").write_text(DENSE)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-dense", "source": conf["source"],
                           "file": "bench/configs/tiny-dense.json", "reduced": [], "why": "test"})
    for traffic in ("train_4k", "serve_longdoc"):
        name = f"tiny-dense.{traffic}"
        man["workloads"].append({"name": name, "config": "tiny-dense", "traffic": traffic,
                                 "chips": 1, "why": "test"})
        moved = ("train_tokens_per_s",) if traffic == "train_4k" else (
            "ttft_p95_ms", "serve_tokens_per_s")
        for m in man["end_to_end"] + man["per_layer"]:
            if "workloads" in m and (m["name"] in moved or m.get("moves") in moved):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return conf


def test_a_new_family_is_new_files_only(tmp_path):
    root = smoke_copy(tmp_path)
    bench = root / "bench"
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = _add_dense(root, module=True)
    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    assert not (ROOT / "bench" / "families" / "dense.py").exists()

    m = conf["model"]
    dense = manifest.family(m, bench)
    assert leaf_specs(m) == dense.leaf_specs(m)
    train = run.measure("tiny-dense.train_4k", 11, 0.0, True, device="cpu", root=root)
    assert train["correct"], train["checks"]
    steps, window = train["attempted"], train["device"]["window_s"]
    want = 100.0 * steps * 3 * dense.forward_flops(m, 2, 64) / window / PEAK_BF16_FLOPS
    assert train["metrics"]["train_mfu"]["value"] == pytest.approx(want)
    assert "k3_roofline_pct.train" not in train["metrics"]

    serve = run.measure("tiny-dense.serve_longdoc", 11, 0.0, True, device="cpu", root=root)
    assert serve["correct"], serve["checks"]
    assert serve["metrics"]["prefill_mfu"]["value"] > 0
    batches = [{"tokens": [0] * 4, "P": P, "prefill_s": 0.5} for P in (32, 96)]
    got = manifest.reader("prefill_mfu", bench)({"kind": "serve", "batches": batches,
                                                 "conf": conf})
    want = 100.0 * (dense.forward_flops(m, 4, 32, unembed_all=False)
                    + dense.forward_flops(m, 4, 96, unembed_all=False)) / 1.0 / PEAK_BF16_FLOPS
    assert got == pytest.approx(want)
    k3 = SimpleNamespace(device_s=lambda names: 1.0)
    assert manifest.reader("k3_roofline_pct.serve", bench)(
        {"kind": "serve", "trace": k3, "batches": batches, "conf": conf}) is None


def test_a_family_without_a_module_fails_at_set_up(tmp_path, monkeypatch):
    root = smoke_copy(tmp_path)
    _add_dense(root, module=False)
    from bench.harness import program

    def drawn(*args, **kwargs):
        raise AssertionError("weights drawn before the family was found")

    monkeypatch.setattr(program, "model", drawn)
    path = root / "bench" / "families" / "dense.py"
    with pytest.raises(FileNotFoundError, match=str(path)):
        run.measure("tiny-dense.train_4k", 11, 0.0, False, device="cpu", root=root)


def _models(arch):
    return {"full": manifest.config(arch)["model"], "smoke": _smoke_model(arch)}


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weights_flops_and_scans_as_recorded(arch, size):
    m = _models(arch)[size]
    key = f"{arch}/{size}"
    got = [[k, list(shape), init, std] for k, (shape, init, std) in leaf_specs(m).items()]
    assert got == RECORDED["specs"][key]
    for B, S, fwd, prefill, step in RECORDED["flops"][key]:
        assert forward_flops(m, B, S) == fwd
        assert forward_flops(m, B, S, unembed_all=False) == prefill
        assert train_step_flops(m, B, S) == step
    assert [list(s) for s in families.of(m).ssd_scans(m)] == RECORDED["scans"][key]


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_are_bit_identical_to_the_recorded(arch):
    leaves = flat_items(draw(_models(arch)["smoke"], RECORDED["seed"], "cpu"))
    got = {k: hashlib.sha256(t.numpy().tobytes()).hexdigest() for k, t in leaves}
    assert got == RECORDED["leaf_sha256"][arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_metric_readers_as_recorded(arch):
    """The readers over the families' FLOPs and SSD scans, on runs made up
    at the cells' shapes with a trace whose K3 kernels took 0.25 s."""
    conf = manifest.config(arch)
    trace = SimpleNamespace(device_s=lambda names: 0.25)
    for B, S in ((8, 4096), (4, 4096), (2, 64)):
        rec = {"kind": "train", "trace": trace, "steps": 3, "batch": B, "seq": S, "conf": conf,
               "window_s": 40.0}
        for name in ("k3_roofline_pct.train", "k3_bwd_roofline_pct.train", "train_mfu"):
            assert manifest.reader(name)(rec) == RECORDED["readers"][f"{arch}/{name}/{B}x{S}"]
    batches = [{"tokens": [0] * 16, "P": P, "prefill_s": 0.5 + P / 1e4}
               for P in (1024, 1280, 8192, 64)]
    rec = {"kind": "serve", "trace": trace, "batches": batches, "conf": conf}
    for name in ("k3_roofline_pct.serve", "prefill_mfu"):
        assert manifest.reader(name)(rec) == RECORDED["readers"][f"{arch}/{name}"]


@pytest.mark.parametrize("workload", CELLS)
def test_check_numbers_as_recorded(smoke_root, workload):
    out = run.measure(workload, RECORDED["seed"], 0.0, False, device="cpu", root=smoke_root)
    assert {k: v[0] for k, v in out["_numbers"].items()} == RECORDED["numbers"][workload]
