"""A configuration, a traffic mix and a per-layer metric are added as new
files and new manifest entries, with no existing file of the benchmark
edited, and a run finds and reports them."""
from __future__ import annotations

import filecmp
import json

from bench import run
from conftest import ROOT, smoke_copy

READER = '''"""steps_done: the window's completed steps."""


def read(run):
    return run.get("steps")
'''


def test_new_cell_config_traffic_and_metric(tmp_path):
    root = smoke_copy(tmp_path)
    bench = root / "bench"
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    conf = json.loads((bench / "configs" / "mamba2-780m.json").read_text())
    conf["name"] = "tiny-ssm"
    (bench / "configs" / "tiny-ssm.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "train_4k.json").read_text())
    traffic["seq"] = 32
    (bench / "traffic" / "train_tiny.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "steps_done.py").write_text(READER)

    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-ssm", "source": "https://arxiv.org/abs/2405.21060",
                           "file": "bench/configs/tiny-ssm.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny-ssm.train_tiny", "config": "tiny-ssm",
                             "traffic": "train_tiny", "chips": 1, "why": "test"})
    man["end_to_end"][1]["workloads"].append("tiny-ssm.train_tiny")
    man["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "train step",
                             "moves": "train_tokens_per_s", "workloads": ["tiny-ssm.train_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    for rel, data in before.items():
        assert (bench / rel).read_bytes() == data, rel
    assert filecmp.cmp(ROOT / "bench" / "run.py", bench / "run.py", shallow=False)

    out = run.measure("tiny-ssm.train_tiny", 7, 0.0, True, device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_done"] == {"value": 1, "unit": "steps"}
    assert "train_mfu" not in out["metrics"]
    plain = run.measure("tiny-ssm.train_tiny", 7, 0.0, False, device="cpu", root=root)
    assert set(plain["metrics"]) == {"setup_s", "train_tokens_per_s"}
