"""The benchmark loads neither JAX nor the JAX package (``repro``), and the
reference and the model families nothing of the program (``repro_torch``).  Names are compared
by their top-level part whole: ``repro_torch`` begins with ``repro`` but
is not it."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from bench.run import FORBIDDEN, forbidden_modules
from conftest import ROOT

BENCH = ROOT / "bench"


def imported_top_levels(path):
    """The top-level names of every module ``path`` imports (relative
    imports are the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_top_levels(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported_top_levels(path) <= {"__future__", "hashlib", "math", "torch", "bench"}
    for mod in imported_top_levels(path) & {"bench"}:
        assert mod == "bench"
    text = path.read_text()
    assert "repro_torch" not in text and "bench.harness" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "families").glob("*.py")), ids=lambda p: p.name)
def test_families_import_nothing_of_the_program(path):
    """A family is reference code: neither JAX nor the JAX package (the
    test above) nor anything of the program or the harness."""
    assert imported_top_levels(path) <= {"__future__", "importlib", "math", "pathlib", "sys",
                                         "torch", "bench"}
    text = path.read_text()
    assert "repro_torch" not in text and "bench.harness" not in text


def test_whole_names_are_compared():
    assert forbidden_modules({"repro_torch": 1, "repro_torch.models": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"repro.models.lm": 1, "jax._src": 1, "numpy": 1}) == ["jax", "repro"]


def test_a_run_loads_neither():
    """Import every module of the harness and the metric readers, and the
    program's modules that a run drives, in a fresh interpreter."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.run, bench.harness.control, bench.harness.train_cell\n"
        "import bench.harness.serve_cell\n"
        "from bench.harness import manifest\n"
        "[manifest.reader(m['name']) for m in manifest.load()['per_layer'] + "
        "manifest.load()['end_to_end']]\n"
        "[manifest.family(manifest.config(c['name'])['model']) for c in "
        "manifest.load()['configs']]\n"
        "import repro_torch.train.loop, repro_torch.launch.serve\n"
        "print(bench.run.forbidden_modules())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
