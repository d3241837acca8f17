"""Tests of the benchmark.  Run with ``python -m pytest bench/tests``.

Tests marked ``card`` need a CUDA card and skip without one, deciding
inside the test; the rest run on the CPU at the configurations' SMOKE
sizes, in a temporary copy of the benchmark whose configurations and
traffic are cut down (``smoke_root``)."""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_TRAFFIC = {
    "train_4k": {"seq": 64, "ref_row_block": 2},
    "serve_longdoc": {"batch": 4, "prompt_min": 32, "prompt_max": 96, "prompt_multiple": 16,
                      "per_cycle": 3, "new_tokens": 4, "sample_requests": 12},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def smoke_copy(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` under ``dest`` with every
    configuration at its architecture's SMOKE size (train batch 2) and the
    traffic mixes cut to CPU sizes."""
    from repro_torch.configs.registry import get_smoke
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (dest / "bench" / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        conf["model"] = dataclasses.asdict(get_smoke(conf["model"]["arch"]))
        conf["train_batch"] = 2
        path.write_text(json.dumps(conf))
    for name, cut in SMOKE_TRAFFIC.items():
        path = dest / "bench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    return dest


@pytest.fixture
def smoke_root(tmp_path):
    return smoke_copy(tmp_path)
