"""The port stands alone: nothing under ``src/repro_torch/`` (nor
``chip_smoke.py``, nor the port's examples ``examples/torch_*.py``)
imports JAX or the JAX package, and its copies of the NVCache engine and
of the paper's figure benchmarks (``launch/engine_bench/``) cannot drift
from the originals."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "msgpack", "repro"}

# the NVCache engine (NVCache, Policy, NVCacheFS, Tier and BLOB with their
# import closure; kvlite, the legacy stores, the flight dump, the sanitizers
# and lint): copied verbatim, only ``repro.`` -> ``repro_torch.`` in imports
# (rule a) and in whole module-path string literals (rule b)
ENGINE = ([f"core/{n}.py" for n in ("__init__", "api", "cleanup", "drain", "locking", "log",
                                    "namespace", "nvmm", "pager", "policy", "readcache",
                                    "router", "recovery")]
          + [f"obs/{n}.py" for n in ("__init__", "dump", "flight", "metrics", "spans")]
          + [f"storage/{n}.py" for n in ("fsapi", "kvlite", "legacy", "tiers")]
          + [f"analysis/{n}.py" for n in ("__init__", "lint", "lockcheck", "pmcheck",
                                          "racecheck", "sanitize", "trace")])
# numpy-only and stdlib-only modules copied as they are
VERBATIM = ENGINE + ["data/pipeline.py", "runtime/fault.py"]
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)
# a string literal that is a whole module path (racecheck's CORE_MODULES),
# or the literal head of an f-string that is one (f"repro.core.{name}")
_MODPATH = re.compile(r"""(?<![\w.'"])(f?(["']))repro\.(?=(?:\w+\.)*(?:\w+\2|\{))""")


def engine_copy(original: str) -> str:
    """``original`` under the engine copy's rules (a) and (b)."""
    return _MODPATH.sub(r"\1repro_torch.", _IMPORT.sub(r"\1repro_torch.", original))


def _port_files(root=ROOT):
    return (sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
            + sorted((root / "examples").glob("torch_*.py")))


def _forbidden_imports(path: Path):
    rel = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path.name
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib.import_module("repro.x") / f"repro.{...}" module paths
            names = [node.value] if re.fullmatch(
                r"(jax|jaxlib|ml_dtypes|msgpack|repro)(\.\w*)*\.?", node.value) else []
        else:
            continue
        bad += [f"{rel}:{node.lineno}: {n}" for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


def test_scan_catches_a_planted_import(tmp_path):
    f = tmp_path / "planted.py"
    f.write_text("import os\nfrom repro.core import api\nimport jax.numpy as jnp\n"
                 "mod = 'repro.models.lm'\nfrom repro_torch.core import api\n"
                 "import msgpack\nfrom repro_torch.checkpoint import codec\n"
                 "def f():\n    from msgpack import packb\n")
    assert sorted(b.split(": ")[1] for b in _forbidden_imports(f)) == [
        "jax.numpy", "msgpack", "msgpack", "repro.core", "repro.models.lm"]


def test_scan_covers_the_port_s_examples_and_catches_an_import_planted_there(tmp_path):
    """``examples/torch_*.py`` are scanned (the JAX package's own examples
    beside them are not): an ``import repro`` planted in one fails."""
    names = [p.name for p in _port_files() if p.parent.name == "examples"]
    assert names == ["torch_crash_recovery_demo.py", "torch_quickstart.py",
                     "torch_train_e2e.py"]
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "ok.py").write_text("import torch\n")
    (tmp_path / "chip_smoke.py").write_text("import json\n")
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "quickstart.py").write_text("import jax\nimport repro\n")
    (tmp_path / "examples" / "torch_planted.py").write_text(
        (ROOT / "examples" / "torch_quickstart.py").read_text() + "\nimport repro\n")
    bad = [b for f in _port_files(tmp_path) for b in _forbidden_imports(f)]
    assert len(bad) == 1 and bad[0].endswith(": repro") and "torch_planted.py" in bad[0], bad


@pytest.mark.parametrize("rel", VERBATIM)
def test_engine_copy_matches_original(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == engine_copy(original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: the engine copy must "
        f"differ only by the repro. -> repro_torch. rewrite of imports and module paths")


def test_engine_copy_is_complete():
    copied = {str(p.relative_to(PORT)) for d in ("core", "obs", "storage", "analysis")
              for p in (PORT / d).glob("*.py")}
    assert copied == set(ENGINE)


def test_engine_copy_rewrites_module_paths_only():
    """Rule (b) takes whole module-path literals and f-string heads; a
    docstring, help text or a path inside a longer string stays as it is,
    so a copy that changed one fails the comparison."""
    src = ('"""See ``repro.core.log`` and repro.obs."""\n'
           'MODS = ("api", "repro.obs.metrics", \'repro.obs.flight\')\n'
           'mod = f"repro.core.{name}"\n'
           'prog = "python -m repro.obs.dump"\n'
           'path = "src/repro/obs/README.md"\n'
           'other = "repro_extra.x"\n'
           '    from repro.core import locking\n')
    assert engine_copy(src) == (
        '"""See ``repro.core.log`` and repro.obs."""\n'
        'MODS = ("api", "repro_torch.obs.metrics", \'repro_torch.obs.flight\')\n'
        'mod = f"repro_torch.core.{name}"\n'
        'prog = "python -m repro.obs.dump"\n'
        'path = "src/repro/obs/README.md"\n'
        'other = "repro_extra.x"\n'
        '    from repro_torch.core import locking\n')
    original = (ROOT / "src" / "repro" / "obs" / "dump.py").read_text()
    drifted = (PORT / "obs" / "dump.py").read_text().replace(
        'prog="python -m repro.obs.dump"', 'prog="python -m repro_torch.obs.dump"')
    assert drifted != (PORT / "obs" / "dump.py").read_text()
    assert drifted != engine_copy(original)


# ---------------------------------------------------------- engine_bench

BENCH_DIR = PORT / "launch" / "engine_bench"
BENCH = ["backends", "fio_like", "fig3_dbbench", "fig4_ideal", "fig5_saturation",
         "fig6_batching", "fig7_readcache", "fig8_coalescing", "fig9_readpath", "fig10_skew",
         "fig_dualmode", "fig_obs", "run_all", "run"]
_BENCH_IMPORT = re.compile(r"^(\s*from\s+)benchmarks(?=\.|\s+import\b)", re.M)
_SYS_PATH = re.compile(r"^sys\.path\.insert\(.*\n\n?", re.M)
KERN_REFUSED = (
    'KERN_REFUSED = (\n'
    '    "kern is not twinned: benchmarks/kernels_bench.py times the JAX oracle and Pallas "\n'
    '    "interpret mode; the card\'s kernel times come from repro_torch.launch.bench_attention, "\n'
    '    "repro_torch.launch.bench_ssd and chip_smoke.py phase 2")\n\n')
# the two files' own edits, (original, twin), each applied once before the
# general rules: run_all finds the repo root from its package's depth and
# writes under build/; run maps ckpt and roofline to the port's launch/
# twins and refuses kern
BENCH_EDITS = {
    "run_all": [
        ("    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))\n",
         "    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 4)\n"),
        ('    ap.add_argument("--out", default=os.path.join(\n'
         '        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),\n'
         '        "BENCH_pr10.json"))\n',
         '    ap.add_argument("--out", default=os.path.join("build", "engine_bench.json"))\n'),
        ("    result = run(quick=args.quick)\n",
         "    result = run(quick=args.quick)\n"
         '    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)\n'),
    ],
    "run": [
        ("sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))\n\n",
         KERN_REFUSED),
        ('                                  "fig8", "ckpt", "kern"}\n',
         '                                  "fig8", "ckpt"}\n'
         '    if "kern" in which:\n'
         '        sys.exit(KERN_REFUSED)\n'),
        ("        from benchmarks import ckpt_bench\n",
         "        from repro_torch.launch import ckpt_bench\n"),
        ('    if "kern" in which:\n'
         "        from benchmarks import kernels_bench\n"
         "        kernels_bench.run()\n", ""),
        ("        from benchmarks import roofline\n",
         "        from repro_torch.launch import roofline\n"),
    ],
}


def bench_twin(name: str, original: str) -> str:
    """``benchmarks/{name}.py`` under the twin's rewrite: the file's own
    edits, then ``repro.`` -> ``repro_torch.`` and ``benchmarks`` ->
    ``repro_torch.launch.engine_bench`` in imports, the ``sys.path.insert``
    lines dropped."""
    for old, new in BENCH_EDITS.get(name, ()):
        assert original.count(old) == 1, (name, old)
        original = original.replace(old, new)
    text = _IMPORT.sub(r"\1repro_torch.", _SYS_PATH.sub("", original))
    return _BENCH_IMPORT.sub(r"\1repro_torch.launch.engine_bench", text)


def _bench_drift(name: str, twin: str) -> bool:
    return twin != bench_twin(name, (ROOT / "benchmarks" / f"{name}.py").read_text())


@pytest.mark.parametrize("name", BENCH)
def test_engine_bench_twin_matches_original(name):
    assert not _bench_drift(name, (BENCH_DIR / f"{name}.py").read_text()), (
        f"src/repro_torch/launch/engine_bench/{name}.py drifted from benchmarks/{name}.py")


def test_engine_bench_is_complete_and_a_planted_line_drifts():
    """The package holds the 14 twins and its ``__init__``; no twin imports
    ``benchmarks`` or edits ``sys.path``; one changed line in a twin (a
    figure's knob, run's refusal) fails the comparison."""
    assert {p.stem for p in BENCH_DIR.glob("*.py")} == set(BENCH) | {"__init__"}
    for name in BENCH:
        twin = (BENCH_DIR / f"{name}.py").read_text()
        assert "from benchmarks" not in twin and "sys.path.insert" not in twin, name
    for name, old, new in (("fig4_ideal", "random_write(", "random_write( "),
                           ("run", "sys.exit(KERN_REFUSED)", "pass"),
                           ("run_all", '"engine_bench.json"', '"BENCH_pr10.json"')):
        twin = (BENCH_DIR / f"{name}.py").read_text()
        assert twin.count(old) >= 1 and _bench_drift(name, twin.replace(old, new, 1)), name


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA card the chip check exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
