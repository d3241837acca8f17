"""The one-card dry run (``repro_torch.launch.dryrun``) on meta tensors:
records of the assigned cells with their bytes counted by hand, JAX's skip
reason, K1's operation count, and the meta run's FLOPs equal to a real CPU
run's at SMOKE size for every arch and kind of step."""
import json

import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.configs.shapes import SHAPES, applicable, scale_shape
from repro_torch.launch import dryrun
from repro_torch.models.registry import build
from repro_torch.optim.adamw import tree_leaves

GiB = 2**30


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_llama_decode_32k_needs_128_gib_of_cache_and_batch_32_fits():
    cfg = get_config("llama3.2-1b")
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", device="cpu")
    L, kv, hd, S = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 32768
    cache = 2 * L * 128 * S * kv * hd * 2 + 4          # bf16 k and v, the int32 pos
    assert cache - 4 == 128 * GiB
    params = 4 * cfg.param_count()                      # float32
    logits = 128 * 1 * cfg.vocab * 4
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert (rec["state_bytes"], rec["cache_bytes"], rec["input_bytes"], rec["output_bytes"]) == (
        params, cache, 128 * 4, logits)
    assert rec["resident_bytes"] == params + cache + 128 * 4 + logits
    assert not rec["fits_one_card"] and "card" not in rec
    assert rec["k1_calls"] == rec["k1_flops"] == 0     # decode attends in plain torch
    cut = dryrun.counted_record(cfg, scale_shape(SHAPES["decode_32k"], batch=32))
    assert cut["cache_bytes"] == 32 * GiB + 4 and cut["fits_one_card"]


def test_llama_prefill_32k_record_and_k1_operations():
    cfg = get_config("llama3.2-1b")
    rec = dryrun.run_cell("llama3.2-1b", "prefill_32k", device="cpu")
    B, S, H, D = 32, 32768, cfg.n_heads, cfg.head_dim
    assert rec["cache_bytes"] == 2 * cfg.n_layers * B * S * cfg.n_kv_heads * D * 2 + 4
    assert rec["input_bytes"] == B * S * 4 and rec["output_bytes"] == B * cfg.vocab * 4
    assert rec["fits_one_card"]                         # state, inputs, cache, outputs only
    assert rec["k1_calls"] == cfg.n_layers and rec["k1_backward_calls"] == 0
    assert rec["k1_flops"] == cfg.n_layers * 2 * B * H * 2 * D * (S * (S + 1) // 2)
    # the plain attention FLOPs count every score: more than K1's causal half
    assert rec["flops"] > rec["k1_flops"] and rec["flops_note"] == dryrun.FLOPS_NOTE


def test_train_step_counts_the_backward_once_a_layer():
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", device="cpu")
    cfg = get_config("llama3.2-1b")
    B, S, H, D = 256, 4096, cfg.n_heads, cfg.head_dim
    pairs = S * (S + 1) // 2
    assert (rec["k1_calls"], rec["k1_backward_calls"]) == (2 * cfg.n_layers, cfg.n_layers)
    assert rec["k1_flops"] == (2 * cfg.n_layers * 2 * B * H * 2 * D * pairs
                               + cfg.n_layers * 2 * B * H * 5 * D * pairs)
    assert rec["state_bytes"] == 3 * 4 * cfg.param_count() + 4   # params, m, v, step


def test_mamba2_long_500k_record():
    cfg = get_config("mamba2-780m")
    rec = dryrun.run_cell("mamba2-780m", "long_500k", device="cpu")
    L, h, p, n = cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * n
    cache = L * h * p * n * 4 + L * (cfg.ssm_conv - 1) * conv_dim * 2 + 4
    params = sum(t.numel() for t in tree_leaves(build(cfg).init(torch.Generator(), "meta")))
    assert rec["status"] == "ok" and rec["cache_bytes"] == cache
    assert rec["resident_bytes"] == 4 * params + cache + 4 + cfg.vocab * 4
    assert rec["fits_one_card"] and rec["k1_calls"] == 0


def test_llama_long_500k_is_skipped_with_jax_reason():
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", device="cpu")
    ok, reason = jshapes.applicable(jreg.get_config("llama3.2-1b"), jshapes.SHAPES["long_500k"])
    assert not ok and rec["status"] == "skipped" and rec["reason"] == reason


@pytest.mark.parametrize("arch", all_archs())
def test_meta_flops_equal_a_cpu_run_at_smoke_size(arch):
    """Every kind of step: the meta run's FLOPs, bytes and K1 count equal
    the same step's run on the CPU from drawn parameters."""
    cfg = get_smoke(arch)
    for name, full in SHAPES.items():
        if not applicable(cfg, full)[0]:
            continue
        shape = scale_shape(full, seq=64 if full.kind != "decode" else 128, batch=2)
        meta = dryrun.counted_record(cfg, shape, "meta")
        cpu = dryrun.counted_record(cfg, shape, "cpu")
        for key in ("flops", "flops_by_op", "resident_bytes", "k1_calls", "k1_flops"):
            assert meta[key] == cpu[key], (arch, name, key)
        assert meta["flops"] > 0


def test_main_writes_a_record_for_every_cell_of_an_arch(tmp_path):
    assert dryrun.main(["--arch", "llama3.2-1b", "--device", "cpu", "--out", str(tmp_path)]) == 0
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert sorted(recs) == sorted(f"llama3.2-1b__{s}__1x1.json" for s in SHAPES)
    for rec in recs.values():
        assert rec["status"] in ("ok", "skipped")
        if rec["status"] == "ok":
            assert {"resident_bytes", "fits_one_card", "flops", "k1_flops"} <= set(rec)
