"""``BENCHMARK.json`` against the benchmark's contract: names, units and
text fields, every configuration used, every per-layer metric's cells
reporting the end-to-end metric it moves, files where the harness looks
for them, and the check's length within its budget."""
from __future__ import annotations

import json
import re

import pytest

from bench.harness import manifest
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = manifest.load()
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(_text(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_their_keys(section):
    for entry in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_are_unique_and_allowed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_names_units_and_sources():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit, m
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(m["layer"])
    assert {m["name"] for m in MAN["end_to_end"]} == {
        "setup_s", "train_tokens_per_s", "ttft_p95_ms", "serve_tokens_per_s"}


def test_configurations_and_cells():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used, f"{c['name']} has no cell"
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://") and _text(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and set(c["reduced"]) <= set(conf)
        assert set(conf["source_values"]) == set(c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and _text(w["why"]) and NAME.match(w["traffic"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_every_metric_has_a_reader():
    for m in METRICS:
        assert callable(manifest.reader(m["name"])), m["name"]


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(MAN, w)}, (m["name"], w)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        names = {m["name"] for m in manifest.end_to_end(MAN, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(MAN, w["name"])


def test_a_full_check_fits_its_budget():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= MAN["run_seconds"] <= 51 and total <= 43200
