"""The port's examples (``examples/torch_quickstart.py``,
``examples/torch_train_e2e.py``, ``examples/torch_crash_recovery_demo.py``)
run on the CPU: the I/O demo recovers every committed byte, training's
loss falls, the quickstart's second loop resumes at step 20 from its
NVCache-backed checkpoint, and the crash demo reads back every
acknowledged key after a crash and recovery, as the original's code."""
import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_trains_and_resumes_at_step_20(capsys):
    hist, hist2 = _load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "no committed write lost" in out and "quickstart OK" in out
    assert len(hist) == 20 and hist[-1]["loss"] < hist[0]["loss"]
    assert len(hist2) == 5 and "resumed at step 20, ran 5 more steps" in out


def test_train_e2e_tiny_loss_falls():
    mod = _load("torch_train_e2e")
    assert set(mod.PRESETS) == {"tiny", "small", "100m"}
    out = mod.main(["--preset", "tiny", "--steps", "30", "--device", "cpu"])
    assert out["steps"] == 30 and out["last_loss"] < out["first_loss"]
    assert out["nvcache"]["cleanup_entries"] > 0     # checkpoints went through the log


def test_presets_match_the_jax_example():
    jax_presets = _load("train_e2e").PRESETS
    assert _load("torch_train_e2e").PRESETS == jax_presets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crash_demo_reads_back_every_acknowledged_key(seed, capsys):
    _load("torch_crash_recovery_demo").main(seed)
    out = capsys.readouterr().out
    assert re.search(r"^verified [1-9]\d* acknowledged keys: 0 missing$", out, re.M), out
    assert out.rstrip().endswith("OK — every acknowledged write survived the crash")


def test_crash_demo_is_the_original_s_code():
    """Below its docstring, the twin is ``crash_recovery_demo.py`` with
    ``repro.`` -> ``repro_torch.`` in its imports."""
    def body(name, text=None):
        tree = ast.parse(text or (EXAMPLES / f"{name}.py").read_text())
        return ast.dump(ast.Module(tree.body[1:], []))
    original = re.sub(r"^(from|import) repro\.", r"\1 repro_torch.",
                      (EXAMPLES / "crash_recovery_demo.py").read_text(), flags=re.M)
    assert body("torch_crash_recovery_demo") == body(None, original)
