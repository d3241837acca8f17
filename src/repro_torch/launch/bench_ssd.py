"""Time K3 (the SSD scan) of this tree against variants of its source, in
turns, on one card.

    python -m repro_torch.launch.bench_ssd [DIR ...]

Each DIR holds a variant of ``csrc/ssd_scan.cu`` with the ``hopper.cuh``
it includes (put it under ``build/``, which git ignores); a DIR holding an
earlier commit's file with the older one-route interface (no scratch
or route arguments) is called through that interface, so
``build/parent`` can hold the kernel this tree replaced (``git show
<rev>:src/repro_torch/csrc/ssd_scan.cu > build/parent/ssd_scan.cu``).
Every source is built with ``nvcc`` in parallel; each one's output at
mamba2-780m's prefill (b=4, s=2048, h=48, p=64, g=1, n=128, chunk 256,
bf16 x/B/C) is checked against ``ssd_ref`` (y 2e-2, state 2e-3, both
·(1+|ref|)); then all are timed with CUDA events (mean of 20 calls) in the
order a, b, ..., ..., b, a, and the device time of each CUDA kernel of
each source over 20 calls under ``torch.profiler``.  Prints the card's
name and power limit, each check, then one JSON line of times.  A variant
that drops work gives wrong numbers but a time: that is how the cost of a
piece is found.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.bench_attention import in_turns
from repro_torch.launch.profile_serve import _device_ms

SHAPE = dict(b=4, s=2048, h=48, p=64, g=1, n=128, chunk=256)   # mamba2-780m prefill


def runner(src: Path, lib: Path):
    """A function (x, dt, A, B, C, chunk) -> (y, state) that calls the
    library built from ``src``: through ``ssd_scan.launch`` when the source
    has this tree's interface, else through the older one-route interface
    (no scratch or route arguments)."""
    if "int route" in src.read_text():
        entry = ssd.load(lib)
        return lambda *args, chunk: ssd.launch(
            entry, *args, chunk, torch.cuda.current_stream().cuda_stream)[1:]
    fn = ctypes.CDLL(str(lib)).ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run_old(x, dt, A, B, C, *, chunk):
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
        state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                 y.data_ptr(), state.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[x.dtype],
                 b, s, h, p, g, n, chunk, *x.stride(), *dt.stride(), A.stride(0),
                 *B.stride(), *C.stride(), *y.stride()[:3],
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src}: launch failed (CUDA error {err})")
        return y, state
    return run_old


def inputs(gen, dev, b, s, h, p, g, n, dtype=torch.bfloat16):
    """Random K3 inputs: x, B, C in ``dtype``, dt post-softplus, A < 0."""
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.randn((h,), generator=gen, device=dev).exp()
    B = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    return x, dt, A, B, C


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd needs a CUDA card")
    dirs = [Path(d) for d in (sys.argv[1:] if argv is None else argv)]
    srcs = [("tree", ssd.SRC)] + [(d.name, d / ssd.SRC.name) for d in dirs
                                  if (d / ssd.SRC.name).exists()]
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda s: _build.build(s[1]), srcs))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    args = inputs(torch.Generator(dev).manual_seed(0), dev, *(SHAPE[k] for k in "bshpgn"))
    wy, wst = ref.ssd_ref(*args, chunk=SHAPE["chunk"])
    fns = []
    for (name, src), lib in zip(srcs, libs):
        run = runner(src, lib)
        y, st = run(*args, chunk=SHAPE["chunk"])
        dy, ds = (y.float() - wy.float()).abs(), (st - wst).abs()
        ok = (bool((dy <= 2e-2 * (1 + wy.float().abs())).all())
              and bool((ds <= 2e-3 * (1 + wst.abs())).all()))
        print(f"  {name} at {SHAPE}: max abs error y {float(dy.max()):.3e} state "
              f"{float(ds.max()):.3e} {'ok' if ok else 'MISMATCH'}")
        fns.append((name, lambda run=run: run(*args, chunk=SHAPE["chunk"])))
    times = in_turns(fns)
    kernels = {}
    for name, fn in fns:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kernels[name] = {key[:100]: ms / 20 for key, ms in _device_ms(prof)}
    print(json.dumps({"shape": SHAPE, "ms": times, "kernel_ms": kernels}), flush=True)


if __name__ == "__main__":
    main()
