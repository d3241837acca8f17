"""The control of ``correct``: the reference put in the program's place and
computed in float8 products, the precision below the configurations'
bfloat16, has to come out not correct.  On the card at each cell's own
size (``card``: one seed; ``bench/harness/control.py`` reads more), and on
the CPU at SMOKE size, where it has to read well above a sound run."""
from __future__ import annotations

import json

import pytest
import torch

from bench import run
from bench.harness import control, manifest
from bench.reference import model as ref_model
from conftest import ROOT

SEED = 2**31 + 65537
MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def _cell(root, workload):
    cell = manifest.cell(manifest.load(root), workload)
    return (manifest.config(cell["config"], root / "bench"),
            manifest.traffic(cell["traffic"], root / "bench"))


def _fails(kind, numbers, limits):
    return any(numbers[k][0] > v for k, v in limits[kind].items() if k in numbers)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    conf, traffic = _cell(ROOT, workload)
    if traffic["kind"] == "train":
        got = control.train_control(conf, traffic, SEED, torch.device("cuda"))
        assert _fails("train", got["control"], conf["limits"])
    else:
        out = run.measure(workload, SEED, 5.0, False, control=ref_model.fp8_mm)
        assert _fails("serve", out["_control"], conf["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_a_sound_run_at_smoke_size(smoke_root, workload):
    conf, traffic = _cell(smoke_root, workload)
    if traffic["kind"] == "train":
        got = control.train_control(conf, traffic, SEED, torch.device("cpu"))["control"]
        sound = run.measure(workload, SEED, 0.0, False, device="cpu", root=smoke_root)
        assert got["grad_err"][0] > 3 * sound["_numbers"]["grad_err"][0]
    else:       # few served tokens at this size: the widest over three seeds
        outs = [run.measure(workload, SEED + i, 0.0, False, device="cpu", root=smoke_root,
                            control=ref_model.fp8_mm) for i in range(3)]
        assert (max(o["_control"]["served_gap"][0] for o in outs)
                > 3 * max(o["_numbers"]["served_gap"][0] for o in outs))


def test_limits_are_set_for_every_cell():
    for w in MAN["workloads"]:
        conf, traffic = _cell(ROOT, w["name"])
        limits = conf["limits"][traffic["kind"]]
        assert limits["log_lost"] == 0
        assert all(v > 0 for k, v in limits.items() if k != "log_lost")
        json.dumps(limits)
