"""Build a kernel source of ``src/repro_torch/csrc`` with g++ against the CPU
emulation of CUDA in this directory, as a shared library with the source's
own C interface (so the wrappers' ``load`` functions load it as they load
the card's).

The rewrite: the CUDA headers become ``cuda_shim.h``; ``extern __shared__``
arrays become pointers into the shim's shared-memory buffer; each
``kernel<<<grid, block, smem, stream>>>(args)`` launch becomes a loop over
the grid's blocks; mma.sync's wrapper ``mma_bf16`` is renamed so that the
shim's emulation of it is called, and any other inline PTX aborts if it is
reached.  The quoted ``hopper.cuh`` resolves to the shim's, which emulates
its PTX; ``copy_tile``, which is plain code, is taken from the real header
so that the emulation runs it as the card does.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

SHIM = Path(__file__).resolve().parent
CSRC = SHIM.parents[1] / "src" / "repro_torch" / "csrc"


def _function(text: str, head: str) -> str:
    """The definition in ``text`` that starts with ``head``, up to its
    matching closing brace."""
    start = text.index(head)
    depth, i = 0, text.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
        if depth == 0:
            return text[start:i]


def emulation_source(src: str) -> str:
    """``src`` rewritten for the shim."""
    src = src.replace("#include <cuda_bf16.h>", '#include "cuda_shim.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    if '#include "hopper.cuh"' in src:
        copy_tile = _function((CSRC / "hopper.cuh").read_text(),
                              "template <int R, int D>\n__device__ __forceinline__ void copy_tile(")
        src = src.replace('#include "hopper.cuh"',
                          '#include "hopper.cuh"\nnamespace hopper {\n' + copy_tile + "\n}")
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+(?: \w+)?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(shim_smem());", src)
    src = re.sub(r"(\w+(?:<[\w:, ]+>)?)<<<(.+?)>>>\((.*?)\);", r"shim_launch(\2, [&] { \1(\3); });",
                 src)
    src = src.replace("void mma_bf16(", "void mma_bf16_ptx(")
    return src.replace("asm volatile(", "SHIM_ASM(")


def build(src: Path, out: Path, edit=None) -> Path:
    """g++ build of the emulated ``src`` into the directory ``out``; returns
    the library.  ``edit``, when given, maps the emulated source's text to
    the text that is built (a variant of the kernel).  Fails the calling
    test if g++ is missing or refuses."""
    import pytest
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    cpp = out / f"{src.stem}_shim.cpp"
    text = emulation_source(src.read_text())
    cpp.write_text(edit(text) if edit is not None else text)
    lib = out / f"lib{src.stem}_shim.so"
    res = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared", "-w",
                          "-I", str(SHIM), "-I", str(CSRC), "-o", str(lib), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return lib
