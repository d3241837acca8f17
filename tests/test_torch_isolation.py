"""The port stands alone: nothing under ``src/repro_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its copy of the
NVCache engine cannot drift from the original."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "msgpack", "repro"}

# the engine's import closure as NVCache, Policy, NVCacheFS, Tier and BLOB
# need it: copied verbatim, only ``repro.`` -> ``repro_torch.`` in imports
ENGINE = ([f"core/{n}.py" for n in ("__init__", "api", "cleanup", "drain", "locking", "log",
                                    "namespace", "nvmm", "pager", "policy", "readcache",
                                    "router", "recovery")]
          + [f"obs/{n}.py" for n in ("__init__", "flight", "metrics", "spans")]
          + ["storage/fsapi.py", "storage/tiers.py"])
# numpy-only modules copied as they are
VERBATIM = ENGINE + ["data/pipeline.py"]
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


@pytest.mark.parametrize("rel", VERBATIM)
def test_engine_copy_matches_original(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _IMPORT.sub(r"\1repro_torch.", original), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: the engine copy must "
        f"differ only by the repro. -> repro_torch. import rewrite")


def test_engine_copy_is_complete():
    copied = {str(p.relative_to(PORT)) for d in ("core", "obs", "storage")
              for p in (PORT / d).glob("*.py")}
    assert copied == set(ENGINE)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA card the chip check exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
