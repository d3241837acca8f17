"""The traffic generator and the window arithmetic: the same seed gives
the same inputs, every seed gets the same set of sizes, and the p95 and
the window's rates come out of synthetic timestamps as defined."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench.harness import serve_cell, stats
from bench.harness.tokens import SyntheticTokens, zipf_tokens
from conftest import ROOT

SERVE = json.loads((ROOT / "bench" / "traffic" / "serve_longdoc.json").read_text())
BIG = 2**31 + 977


def test_tokens_are_a_function_of_seed_and_step():
    a = SyntheticTokens(50280, 8, 64, seed=BIG).batch_at(3)
    b = SyntheticTokens(50280, 8, 64, seed=BIG).batch_at(3)
    assert np.array_equal(a, b) and a.dtype == np.int32
    assert not np.array_equal(a, SyntheticTokens(50280, 8, 64, seed=BIG + 1).batch_at(3))
    assert a.min() >= 1 and a.max() <= 50280 - 2
    assert len({r.tobytes() for r in a}) == 8          # every row differs


def test_the_loop_interface_resumes():
    p = SyntheticTokens(100, 2, 8, seed=BIG)
    first = [p.next()["tokens"] for _ in range(3)]
    q = SyntheticTokens(100, 2, 8, seed=BIG)
    q.load_state({"seed": BIG, "step": 2})
    assert np.array_equal(q.next()["tokens"], first[2])


def test_serving_lengths_are_the_same_set_for_every_seed():
    ls = serve_cell.lengths(SERVE)
    assert ls[0] == SERVE["prompt_min"] and ls[-1] == SERVE["prompt_max"]
    assert all(v % SERVE["prompt_multiple"] == 0 for v in ls)
    for seed in (0, 7, BIG):
        cycle = [serve_cell.length_of(SERVE, seed, i) for i in range(len(ls))]
        assert sorted(cycle) == sorted(ls)
    assert ([serve_cell.length_of(SERVE, BIG, i) for i in range(16)]
            == [serve_cell.length_of(SERVE, BIG, i) for i in range(16)])


def test_serving_window_holds_whole_cycles(smoke_root):
    """A window of no seconds still serves one whole cycle of lengths."""
    from bench import run
    from bench.harness import manifest
    traffic = manifest.traffic("serve_longdoc", smoke_root / "bench")
    out = run.measure("mamba2-780m.serve_longdoc", BIG, 0.0, False, device="cpu", root=smoke_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] == traffic["per_cycle"] * traffic["batch"]


def test_prompts_and_sample_are_a_function_of_the_seed():
    assert np.array_equal(serve_cell.prompts(SERVE, 32001, BIG, 4, 256),
                          zipf_tokens(BIG, 4, (SERVE["batch"], 256), 32001, SERVE["zipf_a"]))
    recs = [{"P": serve_cell.length_of(SERVE, BIG, i)} for i in range(20)]
    pick = serve_cell.sample(recs, SERVE, BIG)
    assert pick == serve_cell.sample(recs, SERVE, BIG)
    assert len(pick) == len(set(pick)) == SERVE["sample_requests"]
    assert recs[pick[0][0]]["P"] == max(r["P"] for r in recs)


def test_percentile_is_the_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0] * 19 + [9.0], 95) == 5.0
    assert stats.percentile([5.0] * 18 + [9.0, 9.0], 95) == 9.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_window_rate():
    assert stats.rate(32768 * 18, 10.0, 10.0 + 38.4) == pytest.approx(15360.0)
    with pytest.raises(ValueError):
        stats.rate(1, 5.0, 5.0)


def test_serving_metrics_from_synthetic_timestamps():
    """Three batches of four requests: TTFTs 1, 2 and 3 s, prompts of 10,
    20 and 30 tokens and 2 new tokens each, in a 12 s window."""
    from bench.harness import manifest
    from bench.work.flops import forward_flops
    import torch
    batches = [{"P": 10 * k, "ttft_s": float(k), "prefill_s": 0.5 * k, "decode_s": 0.2,
                "tokens": torch.zeros((4, 2), dtype=torch.int32)} for k in (1, 2, 3)]
    run = {"kind": "serve", "batches": batches, "t0": 100.0, "t1": 112.0, "window_s": 12.0,
           "append_s": [1e-4, 3e-4], "trace": None, "setup_s": 5.0,
           "conf": json.loads((ROOT / "bench/configs/mamba2-780m.json").read_text())}
    read = lambda name: manifest.reader(name)(run)       # noqa: E731
    assert read("ttft_p95_ms") == pytest.approx(3000.0)
    assert read("serve_tokens_per_s") == pytest.approx(4 * (12 + 22 + 32) / 12.0)
    assert read("decode_step_ms") == pytest.approx(1e3 * 0.6 / 6)
    m = run["conf"]["model"]
    prefill = sum(forward_flops(m, 4, P, unembed_all=False) for P in (10, 20, 30))
    assert prefill == sum(forward_flops(m, 4, P) - 2 * m["d_model"] * m["vocab"] * 4 * (P - 1)
                          for P in (10, 20, 30))
    assert read("prefill_mfu") == pytest.approx(100 * prefill / 3.0 / 989e12)
    assert read("log_append_ms.serve") == pytest.approx(0.2)
    assert read("train_tokens_per_s") is None and read("k3_roofline_pct.serve") is None
    assert read("setup_s") == 5.0


def test_training_metrics_from_synthetic_timestamps():
    from bench.harness import manifest
    from bench.work.flops import train_step_flops
    conf = json.loads((ROOT / "bench/configs/mamba2-780m.json").read_text())
    run = {"kind": "train", "steps": 18, "batch": 8, "seq": 4096, "t0": 3.0, "t1": 43.0,
           "window_s": 40.0, "append_s": [2e-4] * 18, "trace": None, "conf": conf}
    read = lambda name: manifest.reader(name)(run)       # noqa: E731
    assert read("train_tokens_per_s") == pytest.approx(18 * 8 * 4096 / 40.0)
    assert read("train_mfu") == pytest.approx(
        100 * 18 * train_step_flops(conf["model"], 8, 4096) / 40.0 / 989e12)
    assert read("device_idle_pct.train") is None and read("ttft_p95_ms") is None


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._n.startswith("span")


def test_trace_busy_time_idle_gaps_and_kernel_time():
    """Kernels at [10, 30] and [20, 40] (overlapping) and [60, 70] in a
    window [0, 100]; a span on the device's timeline is no device work;
    the host runs op_a through [0, 50] with op_b inside it over [45, 55]."""
    from types import SimpleNamespace

    from bench.harness.trace import Trace
    events = [_Event("ssd_chunk_out", 10, 30, True), _Event("gemm", 20, 40, True),
              _Event("ssd_fwd", 60, 70, True), _Event("span.prefill", 0, 100, True),
              _Event("op_a", 0, 50, False), _Event("op_b", 45, 55, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = Trace(prof, 0, 100)
    assert tr.busy_s == pytest.approx(40e-9)
    assert tr.gaps() == [(0, 10), (40, 60), (70, 100)]
    assert tr.device_s(("ssd_chunk_out", "ssd_fwd")) == pytest.approx(30e-9)
    assert tr.top_device_ops(1) == [["ssd_chunk_out", pytest.approx(20e-9)]]
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    assert gaps == {"python": pytest.approx(30e-9), "op_b": pytest.approx(20e-9),
                    "op_a": pytest.approx(10e-9)}
