"""Build a hand-written CUDA kernel at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  ``build``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library under
``build/`` at the root of the checkout, named by the source's hash, so a
library built from the same source is reused; the wrappers load it with
``ctypes``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def build(src: Path) -> Path:
    """Compile ``src`` unless a library built from this exact source is
    already in ``build/``; returns the library's path.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept next
    to it as ``<library>.log``."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{lib}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} with code {res.returncode}:\n"
                           f"{res.stderr[-6000:]}")
    os.replace(tmp, lib)
    return lib
