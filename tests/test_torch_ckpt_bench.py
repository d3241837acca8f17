"""The port's checkpoint bench (``repro_torch.launch.ckpt_bench``) against
``benchmarks/ckpt_bench.py``: the same four stacks in the same order, every
restore held, and each stack's checkpoint the same number of bytes as the
JAX bench writes from the same numpy state; its copies of ``SCALE`` and of
the checkpoint policy equal ``benchmarks/backends.py``'s."""
import dataclasses

import numpy as np

from benchmarks import backends
from benchmarks import ckpt_bench as jbench
from repro_torch.checkpoint.manager import flatten
from repro_torch.launch import ckpt_bench


def test_rows_match_the_jax_bench_at_1_mib():
    got = ckpt_bench.run(mib=1, device="cpu")
    want = jbench.run(mib=1)
    assert [r["stack"] for r in got] == [r["stack"] for r in want] == [
        "blob-sync", "nvcache", "page-cache-unsafe", "nvcache+int8"]
    for g, w in zip(got, want):
        assert g["restore_ok"] and w["restore_ok"], g["stack"]
        assert g["bytes"] == w["bytes"], g["stack"]
        assert g["state_bytes"] == 3 * (1 << 20) + 4
        assert g["save_s"] > 0 and g["drain_s"] >= 0


def test_state_scale_and_policy_are_the_jax_bench_s():
    state = dict(flatten(ckpt_bench._state(2)))
    want = jbench._state(2)
    for key, arr in (("params/w", want["params"]["w"]), ("opt/m", want["opt"]["m"]),
                     ("opt/v", want["opt"]["v"]), ("opt/step", want["opt"]["step"])):
        np.testing.assert_array_equal(state[key].numpy(), arr)
        assert str(state[key].dtype).removeprefix("torch.") == str(np.asarray(arr).dtype)
    assert ckpt_bench.SCALE == backends.SCALE
    for log_mib in (64, 256, 0.01):
        assert (dataclasses.asdict(ckpt_bench.checkpoint_policy(log_mib))
                == dataclasses.asdict(backends.policy(log_mib, entry=65536)))


def test_restore_check_catches_a_changed_leaf():
    state = ckpt_bench._state(0.01)
    got = {k: {kk: v.clone() for kk, v in d.items()} for k, d in state.items()}
    assert ckpt_bench._restored(got, state, int8=False)
    got["opt"]["v"][0, 0] += 1
    assert not ckpt_bench._restored(got, state, int8=False)
    got["params"]["w"] += 0.04     # int8 holds the parameters to 0.05, as JAX's bench
    assert ckpt_bench._restored(got, state, int8=True)
    got["params"]["w"] += 0.02
    assert not ckpt_bench._restored(got, state, int8=True)
