"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix and the readers of its per-layer metrics, each found by name.

* a configuration ``<name>`` is ``bench/configs/<name>.json``;
* a traffic mix ``<name>`` is ``bench/traffic/<name>.json``, whose
  ``kind`` ("train" or "serve") picks the harness module that runs it;
* a per-layer metric ``<name>`` is read by ``bench/metrics/<name>.py``'s
  ``read(run)``;
* a configuration's model family ``<family>`` (its ``model.family``) is
  ``bench/families/<family>.py``: its weights, plain forward, FLOPs and
  SSD scans (``bench/families/__init__.py``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from bench import families

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(manifest: dict, workload: str) -> list:
    """The end-to-end metrics that ``workload`` reports."""
    return [m for m in manifest["end_to_end"] if _applies(m, workload)]


def per_layer(manifest: dict, workload: str) -> list:
    """The per-layer metrics that ``workload`` reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of the per-layer metric ``name``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(m: dict, bench: Path = BENCH):
    """The module of the model ``m``'s family, loaded from ``bench`` and
    used by the weights, the reference and the work count from here on;
    raises, naming the file to add, where there is none."""
    return families.load(m["family"], bench / "families")
