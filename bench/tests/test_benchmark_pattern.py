"""The ``nemotron-3-nano-30b-a3b.serve_longdoc`` cell and the files that bring
it: the configuration (the catalog's published numbers and the cut), the
``pattern`` family (``bench/families/pattern.py``: weights in the
program's layout, the plain forward, its FLOPs and SSD scans), the held
experts' work (``bench/work/moe.py``) and the readers ``moe_idle_pct.serve``
and ``moe_roofline_pct.serve`` on hand-made traces; the cell runs
``correct`` on the CPU at SMOKE size with the serving readers it shares;
and the cell is new files and appended manifest entries only, with no
existing file of the benchmark edited."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

from bench import families, run
from bench.harness import manifest
from bench.reference.weights import flat_items, leaf_specs
from bench.work.moe import moe_work
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_work
from conftest import ROOT, smoke_copy
from test_benchmark_spans import _trace

NAME = "nemotron-3-nano-30b-a3b"
CELL = f"{NAME}.serve_longdoc"
CONF = manifest.config(NAME)
M = CONF["model"]
SEED = 2**31 + 40961
HERE = Path(__file__).resolve().parent
# this cell's files, all new (paths under bench/)
ADDED = (f"configs/{NAME}.json", "families/pattern.py", "work/moe.py",
         "metrics/moe_idle_pct.serve.py", "metrics/moe_roofline_pct.serve.py")
NEW_METRICS = ("moe_idle_pct.serve", "moe_roofline_pct.serve")
# the serving metrics whose ``workloads`` this cell was appended to
SHARED = ("ttft_p95_ms", "serve_tokens_per_s", "prefill_mfu", "decode_step_ms",
          "k3_roofline_pct.serve", "device_idle_pct.serve", "prefill_idle_pct.serve",
          "decode_idle_pct.serve", "decode_launches.serve", "log_append_ms.serve")
# the published config.json's numbers (the model-configs catalog's row)
PUBLISHED = {"hidden_size": 2688, "num_hidden_layers": 52, "vocab_size": 131072,
             "mamba_num_heads": 64, "mamba_head_dim": 64, "n_groups": 8,
             "ssm_state_size": 128, "chunk_size": 128, "conv_kernel": 4,
             "num_attention_heads": 32, "num_key_value_heads": 2, "head_dim": 128,
             "moe_intermediate_size": 1856, "moe_shared_expert_intermediate_size": 3712,
             "n_routed_experts": 128, "num_experts_per_tok": 6, "routed_scaling_factor": 2.5,
             "norm_eps": 1e-5, "hybrid_override_pattern":
             "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"}


def test_configuration_holds_the_published_widths_and_states_the_cut():
    for k, v in PUBLISHED.items():
        assert CONF[k] == v, k
    pairs = {"d_model": "hidden_size", "n_layers": "num_hidden_layers", "vocab": "vocab_size",
             "ssm_n_heads": "mamba_num_heads", "ssm_head_dim": "mamba_head_dim",
             "ssm_groups": "n_groups", "ssm_state": "ssm_state_size", "ssm_chunk": "chunk_size",
             "ssm_conv": "conv_kernel", "n_heads": "num_attention_heads",
             "n_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
             "d_expert": "moe_intermediate_size",
             "d_shared": "moe_shared_expert_intermediate_size",
             "router_experts": "n_routed_experts", "top_k": "num_experts_per_tok",
             "routed_scale": "routed_scaling_factor", "norm_eps": "norm_eps",
             "block_pattern": "hybrid_override_pattern"}
    assert {k: M[k] for k in pairs} == {k: CONF[v] for k, v in pairs.items()}
    assert M["n_experts"] == CONF["n_experts"] == 64 and CONF["source_values"] == {
        "n_experts": 128}
    entry = next(c for c in manifest.load()["configs"] if c["name"] == NAME)
    assert entry["reduced"] == CONF["reduced"] == ["n_experts"]
    assert (M["pos"], M["param_dtype"], M["compute_dtype"]) == ("none", "bfloat16", "bfloat16")
    assert "two-way expert parallelism" in CONF["deployment"]
    assert {"weights", "e_score_correction_bias", "positions"} <= set(CONF["assumed"])


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_weights_have_the_programs_layout(size):
    """Path, shape and dtype against the program's ``init_lm`` on ``meta``;
    the embedding, unembedding and final norm are the reference's float32
    leaves (its shared ``unembed`` multiplies in the leaves' dtype), which
    the program casts where it reads them."""
    import torch

    from bench.harness import program
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models import lm
    m = M if size == "full" else json.loads(json.dumps(dataclasses.asdict(get_smoke(NAME))))
    cfg = program.model_config(m)
    prog = dict(flat_items(lm.init_lm(cfg, torch.Generator().manual_seed(0), "meta")))
    specs = leaf_specs(m)
    assert {k: v[0] for k, v in specs.items()} == {k: tuple(v.shape) for k, v in prog.items()}
    top = ("embed", "unembed", "final_norm")
    for k, (_, init, _) in specs.items():
        want = torch.float32 if k in top or not init.startswith("bf16_") else torch.bfloat16
        assert want == (torch.float32 if k in top else prog[k].dtype), k


def test_forward_flops_by_hand():
    """One 4096-token sequence: a Mamba block 2·2688·10304 + 2·4096·2688 a
    token plus its scan; an MoE block's router 2·2688·128, 3 held pairs a
    token (6 · 64/128) of two 2·2688·1856 products, the shared expert's
    two 2·2688·3712; an attention block's projections 2·2688·(2·4096 +
    2·256) a token and 2·32·256 a visible pair; the unembedding 2·2688·131072
    a position (the last one alone in a prefill): 4.637 GFLOP a prompt
    token at 4096."""
    T = 4096
    mamba = (2 * 2688 * 10304 + 2 * 4096 * 2688) * T + ssd_work(1, T, 64, 64, 8, 128, 128, 2)[0]
    moe = (2 * 2688 * 128 + 3 * 2 * 2 * 2688 * 1856 + 2 * 2 * 2688 * 3712) * T
    attn = 2 * 2688 * (2 * 4096 + 2 * 256) * T + 2 * 32 * 256 * T * (T + 1) // 2
    body = 23 * mamba + 23 * moe + 6 * attn
    family = families.of(M)
    assert family.forward_flops(M, 1, T) == body + 2 * 2688 * 131072 * T
    assert family.forward_flops(M, 1, T, unembed_all=False) == body + 2 * 2688 * 131072
    assert family.forward_flops(M, 1, T, unembed_all=False) / T == pytest.approx(4.637e9, rel=1e-3)


def test_ssd_scans_and_the_held_experts_work():
    assert families.of(M).ssd_scans(M) == [(23, 64, 64, 8, 128, 128)]
    assert moe_work(M, 131072) == (7846905249792, 8424259584)     # the module's example
    flops, nbytes = moe_work(M, 16 * 1024)
    assert flops == 16 * 1024 * 3 * 2 * 2 * 2688 * 1856
    assert nbytes == (64 * 2 * 2688 * 1856 + 16 * 1024 * 3 * 2 * (2688 + 1856)) * 2


def test_the_cell_runs_correct_at_smoke_size_with_the_shared_readers(smoke_root):
    plain = run.measure(CELL, SEED, 0.0, False, device="cpu", root=smoke_root)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"setup_s", "ttft_p95_ms", "serve_tokens_per_s"}
    traced = run.measure(CELL, SEED, 0.0, True, device="cpu", root=smoke_root)
    assert traced["correct"], traced["checks"]
    # on the CPU the trace has no device events: the device readers read None
    assert set(traced["metrics"]) == {
        "prefill_mfu", "decode_step_ms", "prefill_idle_pct.serve", "decode_idle_pct.serve",
        "decode_launches.serve", "log_append_ms.serve", "moe_idle_pct.serve"}
    assert traced["metrics"]["moe_idle_pct.serve"]["value"] == 100.0


def _read(name, run_rec):
    return manifest.reader(name, ROOT / "bench")(run_rec)


# kernels: a grouped product [10, 40] and another kernel [40, 60] in the
# first prefill [0, 100); a grouped product [520, 530] in a decode step; a
# grouped product [700, 760] in the second prefill [690, 800) (to the
# window's end: no decode step after it).  MoE layers [5, 30] and [35, 70]:
# idle inside them 5 + (60, 70] = 15 of 60 ns.
GROUPED = "void cutlass::device_kernel<GemmUniversal<cutlass::gemm::GroupProblemShape<x>>>"
EVENTS = [(GROUPED, 10, 40, True), ("elementwise", 40, 60, True), (GROUPED, 520, 530, True),
          (GROUPED, 700, 760, True),
          ("serve.prefill", 0, 100, False), ("moe.layer", 5, 30, False),
          ("moe.layer", 35, 70, False), ("serve.decode_step", 500, 600, False),
          ("serve.prefill", 690, 720, False)]


def _serve_run(conf, events=EVENTS):
    batches = [{"tokens": [[0] * 16] * 16, "P": 1024}, {"tokens": [[0] * 16] * 16, "P": 8192}]
    return {"kind": "serve", "trace": _trace(events, 0, 800), "batches": batches, "conf": conf}


def test_moe_idle_share_of_the_layer_ranges():
    assert _read("moe_idle_pct.serve", _serve_run(CONF)) == pytest.approx(100 * 15 / 60)
    bare = [e for e in EVENTS if e[0] != "moe.layer"]
    assert _read("moe_idle_pct.serve", _serve_run(CONF, bare)) is None
    assert _read("moe_idle_pct.serve", {**_serve_run(CONF), "trace": None}) is None
    assert _read("moe_idle_pct.serve", {**_serve_run(CONF), "kind": "train"}) is None


def test_moe_roofline_over_the_prefills_grouped_products():
    """The least time of both prefills' held experts (16 x 1024 and 16 x
    8192 tokens, 23 blocks) over the grouped kernels inside the prefills,
    30 + 60 ns; the decode step's and the other kernel's time left out."""
    want = sum(23 * bound_s(*moe_work(M, 16 * P))[0] for P in (1024, 8192))
    assert _read("moe_roofline_pct.serve", _serve_run(CONF)) == pytest.approx(
        100 * want / 90e-9)
    none = [e for e in EVENTS if e[0] != GROUPED]
    assert _read("moe_roofline_pct.serve", _serve_run(CONF, none)) is None
    mamba2 = manifest.config("mamba2-780m")
    assert _read("moe_roofline_pct.serve", _serve_run(mamba2)) is None
    assert _read("moe_roofline_pct.serve", {**_serve_run(CONF), "trace": None}) is None


def test_grouped_kernel_names_are_not_the_other_cells_device_ops():
    """None of the device operations of the four cells before this one (their
    traced breakdowns' ``device_ops``, kept in ``older_cells_device_ops.json``)
    carries a name the roofline reads."""
    mod = manifest.reader("moe_roofline_pct.serve", ROOT / "bench").__globals__
    older = json.loads((HERE / "older_cells_device_ops.json").read_text())["device_ops"]
    ops = [op for cell in older.values() for op in cell]
    assert set(older) == {f"{m}.{t}" for m in ("mamba2-780m", "hymba-1.5b")
                          for t in ("train_4k", "serve_longdoc")}
    assert ops and not [op for op in ops if any(k in op for k in mod["GROUPED"])]
    assert any(k in GROUPED for k in mod["GROUPED"])


def test_the_readers_read_ranges_the_program_opens():
    from repro_torch.runtime.ranges import NAMES
    assert {"moe.layer", "serve.prefill", "serve.decode_step"} <= NAMES


def _without_the_cell(man: dict) -> dict:
    """The manifest as it was before this cell: its configuration, cell and
    metrics taken out, and its name out of every metric's ``workloads``."""
    out = json.loads(json.dumps(man))
    out["configs"] = [c for c in out["configs"] if c["name"] != NAME]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if m["name"] not in NEW_METRICS]
    for m in out["end_to_end"] + out["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].remove(CELL)
    return out


def test_the_cell_is_new_files_and_appended_entries(tmp_path):
    """Take this cell's files and entries out of a copy of the benchmark,
    put them back as new files and entries appended at the end of their
    lists, and find no existing file edited; then the copy runs the cell."""
    root = smoke_copy(tmp_path)
    bench = root / "bench"
    added = {rel: (bench / rel).read_bytes() for rel in ADDED}
    for rel in ADDED:
        (bench / rel).unlink()
    man = json.loads((root / "BENCHMARK.json").read_text())
    parent = _without_the_cell(man)
    (root / "BENCHMARK.json").write_text(json.dumps(parent))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    for rel, data in added.items():
        assert not (bench / rel).exists()
        (bench / rel).write_bytes(data)
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        old, new = parent[section], man[section]
        assert [e["name"] for e in new[:len(old)]] == [e["name"] for e in old]
        for o, n in zip(old, new):
            grown = {**n, "workloads": o.get("workloads")} if "workloads" in o else n
            assert grown == o, o["name"]
            if "workloads" in o and n["workloads"] != o["workloads"]:
                assert n["workloads"] == o["workloads"] + [CELL], o["name"]
                assert o["name"] in SHARED
    assert {m["name"] for m in man["per_layer"][len(parent["per_layer"]):]} == set(NEW_METRICS)
    out = run.measure(CELL, SEED, 0.0, False, device="cpu", root=root)
    assert out["correct"], out["checks"]
