"""The port's roofline (``repro_torch.launch.roofline``) on H100 constants:
the three terms of a record computed by hand, ``model_flops`` equal to the
JAX package's ``benchmarks/roofline.model_flops`` on the same record
fields, the link a group crosses, the bound column's numbers (``PERF.md``
§6: the same work functions now serve ``chip_smoke.py`` and the dry run),
and the CLI over the dry run's records."""
import importlib.util
import json
import os

import pytest

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_roofline():
    """``benchmarks/roofline.py``, loaded from its file (it imports its
    sibling ``hlo_analysis`` itself)."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "benchmarks", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(**kw):
    rec = {"arch": "a", "shape": "train_4k", "status": "ok", "batch": 256, "devices": 256,
           "active_params": 1_000_000_000,
           "work_flops_by_dtype": {"bfloat16": 989e12, "float32": 6.7e12},
           "work_hbm_bytes": 3.35e12, "work_flops": 989e12 + 6.7e12,
           "groups": {"model": {"size": 16, "ranks": list(range(16)), "wire_bytes": 50e9},
                      "data": {"size": 16, "ranks": list(range(0, 256, 16)),
                               "wire_bytes": 25e9}}}
    rec.update(kw)
    return rec


def test_terms_by_hand():
    t = roofline.terms(_record())
    # 1 s of bf16 at 989 TFLOP/s, 0.1 s of f32 at 67 TFLOP/s
    assert t["t_compute"] == pytest.approx(1.0 + 0.1)
    assert t["t_memory"] == pytest.approx(1.0)                    # 3.35 TB at 3.35 TB/s
    # both groups span nodes of 8: one NDR port a card, 50 GB/s
    assert t["t_collective"] == pytest.approx(1.0 + 0.5)
    out = roofline.analyze(_record())
    assert out["bottleneck"] == "collective"
    assert out["model_flops"] == pytest.approx(6 * 1e9 * 4096 * 256 / 256)
    assert out["useful_ratio"] == pytest.approx(out["model_flops"] / (989e12 + 6.7e12))
    assert out["roofline_fraction"] == pytest.approx(out["model_flops"] / 989e12 / 1.5)


@pytest.mark.parametrize("shape", list(roofline.SHAPE_TOKENS))
@pytest.mark.parametrize("devices", [256, 512])
def test_model_flops_equal_jax(shape, devices):
    jr = _jax_roofline()
    assert roofline.SHAPE_TOKENS == jr.SHAPE_TOKENS
    rec = {"shape": shape, "active_params": 1_235_814_400, "devices": devices,
           "batch": SHAPES[shape].batch}
    assert roofline.model_flops(rec) == jr.model_flops(rec)
    # a batch cut scales the tokens
    cut = {**rec, "batch": max(1, rec["batch"] // 8)}
    assert roofline.model_flops(cut) == pytest.approx(
        jr.model_flops(rec) * cut["batch"] / rec["batch"])


def test_link_inside_a_node_and_across_nodes():
    assert roofline.link_bytes(range(8)) == roofline.NVLINK_BYTES == 450e9
    assert roofline.link_bytes([8, 10, 15]) == roofline.NVLINK_BYTES
    assert roofline.link_bytes([0, 16]) == roofline.NDR_BYTES == 50e9     # a data group
    assert roofline.link_bytes(range(16)) == roofline.NDR_BYTES           # the 16-wide model axis
    assert roofline.link_bytes([7, 8]) == roofline.NDR_BYTES
    one_node = _record(groups={"model": {"size": 4, "ranks": [0, 1, 2, 3], "wire_bytes": 45e9}})
    assert roofline.terms(one_node)["t_collective"] == pytest.approx(0.1)


def test_bound_column_reads_the_same_numbers():
    """PERF.md §6's bound column (``chip_smoke.py`` on the H100): K1 at
    llama's prefill, the K1 backward, K3 at mamba2's, K3's backward at
    mamba2's (bf16 and fp32 peaks) and hymba's train shapes, and K2 on the
    embedding's gradient."""
    bf16, f32 = roofline.PEAK_BF16_FLOPS, roofline.PEAK_F32_FLOPS
    assert (bf16, f32, roofline.PEAK_BYTES) == (989e12, 67e12, 3.35e12)
    cases = [(roofline.attention_bound(4, 2048, 2048, 32, 8, 64, 64, 2, True, 0, bf16),
              0.0695, "operations"),
             (roofline.attention_bound(16, 32768, 32768, 32, 8, 64, 64, 2, True, 0, bf16),
              71.1536, "operations"),
             (roofline.attention_bwd_bound(4, 2048, 2048, 32, 8, 64, 64, 2, True, 0, bf16),
              0.1738, "operations"),
             (roofline.ssd_bound(4, 2048, 48, 64, 1, 128, 256, 2, bf16), 0.0336, "bytes"),
             (roofline.ssd_bwd_bound(4, 2048, 48, 64, 1, 128, 256, 2, bf16), 0.0721, "operations"),
             (roofline.ssd_bwd_bound(4, 2048, 48, 64, 1, 128, 256, 2, f32), 1.064, "operations"),
             (roofline.ssd_bwd_bound(4, 2048, 50, 64, 1, 16, 256, 2, bf16), 0.0482, "bytes"),
             (roofline.quantize_bound(128256 * 2048, 256, 4), 0.3933, "bytes")]
    for (ms, by), want, want_by in cases:
        assert (round(ms, 4), by) == (want, want_by)


def test_cli_over_the_dry_runs_records(tmp_path, capsys):
    recs = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--device", "cpu",
                        "--out", str(recs)]) == 0
    # a card run's record beside it: the cut's counts and its measured steps
    rec = json.loads((recs / "llama3.2-1b__decode_32k__1x1.json").read_text())
    cut = dryrun.counted_record(dryrun.get_config("llama3.2-1b"),
                                dryrun.scale_shape(dryrun.SHAPES["decode_32k"], batch=32))
    rec["card"] = {"batch": 32, "step_ms": [208.86, 203.25],
                   "count": {k: cut[k] for k in dryrun.COUNT_KEYS}}
    (recs / "llama3.2-1b__prefill_32k__1x1.json").write_text(json.dumps(
        {**rec, "shape": "prefill_32k", "status": "skipped", "reason": "a test's"}))
    (recs / "llama3.2-1b__decode_32k__1x1.json").write_text(json.dumps(rec))
    assert roofline.main(["--dir", str(recs), "--out", str(tmp_path)]) == 0
    rows = roofline.table(str(recs), "1x1")
    ok = next(r for r in rows if r["status"] == "ok")
    assert ok["t_collective"] == 0 and ok["bottleneck"] == "memory"
    want = max(cut["work_hbm_bytes"] / 3.35e12,
               sum(n / roofline.PEAK_FLOPS[d] for d, n in cut["work_flops_by_dtype"].items()))
    assert ok["roofline_fraction_measured"] == pytest.approx(want / 0.20325)
    csv = (tmp_path / "roofline_1x1.csv").read_text().splitlines()
    assert csv[0].startswith("arch,shape,status") and len(csv) == 3
    assert "| llama3.2-1b | decode_32k | 1 |" in capsys.readouterr().out
    assert (tmp_path / "roofline_1x1.md").exists()
    assert not (tmp_path / "roofline_single.md").exists()
