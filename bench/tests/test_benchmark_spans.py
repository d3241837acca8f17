"""The readers of the program's ranges (``bench/harness/spans.py`` and the
six metrics over it) on hand-made traces with exact expected values: ranges
that straddle the window's ends, a window without the ranges, launches
just outside a range; and every range name they read is one the program
opens (``repro_torch.runtime.ranges.NAMES``).  On the card (``card``) the
launches a decode step counts against the device work those steps start."""
from __future__ import annotations

import bisect
import importlib.util
from types import SimpleNamespace

import pytest

from bench.harness import manifest, spans
from bench.harness.trace import _union
from bench.harness.trace import Trace
from conftest import ROOT
from test_benchmark_traffic import _Event

TRAIN = ("step_idle_pct.train", "loop_gap_ms.train", "metrics_log_ms.train")
SERVE = ("prefill_idle_pct.serve", "decode_idle_pct.serve", "decode_launches.serve")
SEED = 2**31 + 65537
MAN = manifest.load()
SERVE_CELLS = [w["name"] for w in MAN["workloads"]
               if manifest.traffic(w["traffic"])["kind"] == "serve"]


def _trace(events, t0=0, t1=1000):
    """A ``Trace`` of ``events``: (name, start, end, on the device)."""
    evs = [_Event(*e) for e in events]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    return Trace(prof, t0, t1)


def _read(name, run):
    return manifest.reader(name, ROOT / "bench")(run)


# kernels [100, 300], [350, 600], [700, 900]: gaps [0, 100], [300, 350],
# [600, 700], [900, 1000] (350 ns idle); steps [0, 320] (from -50),
# [340, 650], [690, 1000] (to 1100); a log line outside the window
TRAIN_EVENTS = [("k", 100, 300, True), ("k", 350, 600, True), ("k", 700, 900, True),
                ("train.step", -50, 320, False), ("train.log", 330, 340, False),
                ("train.step", 340, 650, False), ("train.log", 660, 680, False),
                ("train.step", 690, 1100, False), ("train.log", 1010, 1020, False)]


def test_named_ranges_are_clipped_to_the_window():
    tr = _trace(TRAIN_EVENTS)
    assert spans.named(tr, "train.step") == [(0, 320), (340, 650), (690, 1000)]
    assert spans.named(tr, "train.log") == [(330, 340), (660, 680)]
    assert spans.total_ns([(0, 320), (340, 650), (300, 330)]) == 330 + 310


def test_idle_inside_train_steps_and_between_them():
    """Idle inside the steps: 100 + (20 + 10) + (50 + 10) + 100 = 290 of
    940 ns; outside them 350 - 290 = 60 ns over 3 steps."""
    run = {"kind": "train", "trace": _trace(TRAIN_EVENTS), "steps": 3}
    assert spans.idle_ns(run["trace"], spans.named(run["trace"], "train.step")) == 290
    assert _read("step_idle_pct.train", run) == pytest.approx(100 * 290 / 940)
    assert _read("loop_gap_ms.train", run) == pytest.approx(60 / 1e6 / 3)
    assert _read("metrics_log_ms.train", run) == pytest.approx(15 / 1e6)


# kernels [20, 200], [420, 430], [530, 540]; a prefill over [10, 300], two
# decode steps [400, 500] and [500, 600]
SERVE_EVENTS = [("k", 20, 200, True), ("k", 420, 430, True), ("k", 530, 540, True),
                ("serve.prefill", 10, 300, False),
                ("serve.decode_step", 400, 500, False), ("serve.decode_step", 500, 600, False),
                ("cudaLaunchKernel", 399, 402, False), ("cudaLaunchKernel", 400, 404, False),
                ("aten::mm", 450, 460, False), ("cudaLaunchKernel", 451, 455, False),
                ("cudaMemcpyAsync", 500, 510, False), ("cudaGraphLaunch", 550, 560, False),
                ("cuLaunchKernel", 599, 605, False), ("cudaLaunchKernel", 600, 603, False)]


def test_idle_and_launches_inside_prefill_and_decode():
    """Prefill idle 10 + 100 of 290 ns; decode idle 20 + 100 + 60 of 200;
    launches at 400, 451, 500, 550 and 599 (not 399, not 600, not the
    operator): 5 over 2 steps."""
    run = {"kind": "serve", "trace": _trace(SERVE_EVENTS)}
    assert _read("prefill_idle_pct.serve", run) == pytest.approx(100 * 110 / 290)
    assert _read("decode_idle_pct.serve", run) == pytest.approx(100 * 180 / 200)
    assert _read("decode_launches.serve", run) == 2.5


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_no_ranges_in_the_window_read_none(name):
    """A parent without the ranges, ranges wholly outside the window, an
    untraced run and the other kind of cell all read None."""
    kind = "train" if name in TRAIN else "serve"
    bare = [e for e in TRAIN_EVENTS + SERVE_EVENTS if "." not in e[0]]
    outside = [(n, s + 2000, e + 2000, d) for n, s, e, d in TRAIN_EVENTS + SERVE_EVENTS]
    for events in (bare, outside):
        assert _read(name, {"kind": kind, "trace": _trace(events), "steps": 3}) is None
    assert _read(name, {"kind": kind, "trace": None, "steps": 3}) is None
    other = {"train": "serve", "serve": "train"}[kind]
    events = TRAIN_EVENTS + SERVE_EVENTS
    assert _read(name, {"kind": other, "trace": _trace(events), "steps": 3}) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_readers_read_ranges_the_program_opens(name):
    from repro_torch.runtime.ranges import NAMES
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"spans_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SPAN in NAMES
    assert {m["name"] for m in manifest.load(ROOT)["per_layer"]} >= {name}


@pytest.mark.card
@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_decode_launches_match_the_device_work_on_the_card(card, workload):
    """One batch of the cell's shortest prompts through the cell's model,
    at full size, under the profiler: ``decode_launches.serve`` times the
    decode steps equals the CUDA calls (any ``cu...`` host event) that
    started inside a ``serve.decode_step`` range and ran device work, each
    call counted once however many kernels, copies and sets carry its
    correlation id (a ``cudaGraphLaunch`` runs a whole graph's kernels
    under its own), within 0.1%: the counted kinds of call miss no call
    that ran device work, and no counted call ran none."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.harness import program, serve_cell
    from repro_torch.launch import serve

    cell = manifest.cell(MAN, workload)
    conf, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    dev = torch.device("cuda")
    model = program.model(conf, SEED, dev)
    params = model.init()
    n_new = traffic["new_tokens"]
    toks = torch.from_numpy(serve_cell.prompts(traffic, conf["model"]["vocab"], SEED, 0,
                                               traffic["prompt_min"])).to(dev)

    def batch():
        logits, cache = serve.prefill(model, params, toks, n_new)
        serve.decode(model, params, logits, cache, n_new)
        torch.cuda.synchronize()

    with torch.inference_mode():
        batch()                                  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            batch()
            t1 = time.time_ns()
    tr = Trace(prof, t0, t1)
    steps = spans.named(tr, "serve.decode_step")
    merged = _union(steps)
    starts = [s for s, _ in merged]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < merged[i][1]

    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    calls = {e.correlation_id() for e in events if e.device_type() == cpu
             and e.name().startswith("cu") and inside(e.start_ns())}
    counted = {e.correlation_id() for e in events if e.device_type() == cpu
               and e.name() in spans.LAUNCHES and inside(e.start_ns())}
    device = [e.correlation_id() for e in events
              if e.device_type() != cpu and not e.is_user_annotation()]
    work = [c for c in device if c in calls]
    worked = set(work)
    per_step = _read("decode_launches.serve", {"kind": "serve", "trace": tr})
    print(f"{workload}: {len(steps)} decode steps, {per_step} launches a step, "
          f"{len(worked)} calls ran {len(work)} device events "
          f"({len(work) / len(steps)} a step); counted calls without device work: "
          f"{len(counted - worked)}, calls with device work not counted: {len(worked - counted)}")
    assert len(steps) == n_new
    assert per_step * len(steps) == pytest.approx(len(counted))
    assert per_step * len(steps) == pytest.approx(len(worked), rel=1e-3)
    assert len(counted ^ worked) <= 1e-3 * len(worked)
