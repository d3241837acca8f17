"""Time K3 (the SSD scan) or its backward of this tree against variants
of its source, in turns, on one card.

    python -m repro_torch.launch.bench_ssd [--shape NAME] [DIR ...]
    python -m repro_torch.launch.bench_ssd --bwd [DIR ...]

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
each source over 20 calls under ``torch.profiler``.  ``--shape`` names
another shape of ``SHAPES`` (nemotron-3-nano-30b-a3b's prefill: b=16,
s=8192, h=64, p=64, g=8, n=128, chunk 128, x, B and C the views of one
6144-wide row as ``ssm_forward`` hands them over), at which the plain
version is also timed (mean of 3 calls).  Prints the card's
name and power limit, each check, then one JSON line of times.  A variant
that drops work gives wrong numbers but a time: that is how the cost of a
piece is found.  Needs a CUDA card.

``--bwd`` does the same for ``csrc/ssd_scan_bwd.cu``: each DIR holds a
variant of it (with ``hopper.cuh``); one holding an earlier one-route
source (no route argument) is called through that interface.  The tree's
source runs on both its routes (``wgmma``, then ``fma`` on the same
inputs), each variant on ``ssd_bwd_route``'s choice.  At mamba2-780m's and
hymba-1.5b's train shapes (b=4, s=2048, chunk 256, bf16; x, B and C the
views of one 3328- or 3232-wide row, as ``ssm_forward`` hands them over)
each one's gradients are checked against ``ssd_bwd_ref`` (dx, ddt, dB, dC
2e-2·(1+|ref|), dA by ||d||/||ref|| <= 1e-2), then all are timed in turns
(mean of 10 calls) with each CUDA kernel's device time.
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
from repro_torch.launch.bench_attention import cuda_ms, in_turns
from repro_torch.launch.profile_serve import _device_ms

SHAPE = dict(b=4, s=2048, h=48, p=64, g=1, n=128, chunk=256)   # mamba2-780m prefill
SHAPES = {"mamba2-780m": SHAPE,      # the forward's shapes, by the model whose prefill it is
          "nemotron-3-nano-30b-a3b": dict(b=16, s=8192, h=64, p=64, g=8, n=128, chunk=128)}
BWD_SHAPES = {"mamba2-780m": SHAPE, "hymba-1.5b": dict(SHAPE, h=50, n=16)}   # their train steps'
BWD_TOL, BWD_DA_REL = 2e-2, 1e-2


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


def bwd_runner(src: Path, lib: Path, route=None):
    """A function (x, dt, A, B, C, dy, chunk) -> (dx, ddt, dA, dB, dC) that
    calls the backward library built from ``src`` on ``route`` (None:
    ``ssd_bwd_route``'s choice): through ``ssd_scan.launch_bwd`` when the
    source takes a route, else through the older one-route interface."""
    stream = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731
    if "int route" in src.read_text():
        entry = ssd.load_bwd(lib)
        return lambda *args, chunk: ssd.launch_bwd(entry, *args, None, chunk, stream(), route)
    fn = ctypes.CDLL(str(lib)).ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 20 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lambda *args, chunk: ssd.launch_bwd(
        lambda *a: fn(*a[:15], *a[16:]), *args, None, chunk, stream(), "fma")


def projection_views(x, B, C):
    """x, B and C as views of one (b, s, h p + 2 g n) row, as
    ``ssm_forward`` hands them over."""
    h, p = x.shape[2:]
    g, n = B.shape[2:]
    row = torch.cat([x.flatten(2), B.flatten(2), C.flatten(2)], -1)
    return (row[..., :h * p].unflatten(2, (h, p)),
            row[..., h * p:h * p + g * n].unflatten(2, (g, n)),
            row[..., h * p + g * n:].unflatten(2, (g, n)))


def check_grads(got, want):
    """(ok, max |d|/(1+|ref|) by gradient, dA's ||d||/||ref||)."""
    errs = {name: float(((a.float() - w.float()).abs() / (1 + w.float().abs())).max())
            for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want)}
    rel = float((got[2] - want[2]).norm() / want[2].norm())
    ok = all(v <= BWD_TOL for k, v in errs.items() if k != "dA") and rel <= BWD_DA_REL
    return ok, errs, rel


def main_bwd(dirs):
    srcs = [("tree", ssd.BWD_SRC)] + [(d.name, d / ssd.BWD_SRC.name) for d in dirs
                                      if (d / ssd.BWD_SRC.name).exists()]
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda s: _build.build(s[1]), srcs))
    for (name, _), lib in zip(srcs, libs):
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name} ptxas:", line.strip().split("ptxas info    : ")[-1])
    runs = [("tree wgmma", bwd_runner(srcs[0][1], libs[0], "wgmma")),
            ("tree fma", bwd_runner(srcs[0][1], libs[0], "fma"))]
    runs += [(name, bwd_runner(src, lib)) for (name, src), lib in zip(srcs[1:], libs[1:])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    result = {}
    for arch, shape in BWD_SHAPES.items():
        gen = torch.Generator(dev).manual_seed(0)
        x, dt, A, B, C = inputs(gen, dev, *(shape[k] for k in "bshpgn"))
        x, B, C = projection_views(x, B, C)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        args, chunk = (x, dt, A, B, C, dy), shape["chunk"]
        want = ref.ssd_bwd_ref(*args, chunk=chunk)
        fns = []
        for name, run in runs:
            ok, errs, rel = check_grads(run(*args, chunk=chunk), want)
            print(f"  {name} at {arch} {shape}: max |d|/(1+|ref|) "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f", dA ||d||/||ref|| {rel:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
            fns.append((name, lambda run=run: run(*args, chunk=chunk)))
        del want
        times = in_turns(fns, 10)
        kernels = {}
        for name, fn in fns:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            kernels[name] = {key[:100]: ms / 10 for key, ms in _device_ms(prof)}
        result[arch] = {"shape": shape, "ms": times, "kernel_ms": kernels}
        print(json.dumps({arch: result[arch]}), flush=True)
        del x, dt, A, B, C, dy, args
    print(json.dumps({"device": smi.stdout.strip(), "bwd": result}), flush=True)


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd needs a CUDA card")
    argv = sys.argv[1:] if argv is None else argv
    if "--bwd" in argv:
        return main_bwd([Path(d) for d in argv if d != "--bwd"])
    name = "mamba2-780m"
    if "--shape" in argv:
        i = argv.index("--shape")
        name, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    shape = SHAPES[name]
    dirs = [Path(d) for d in argv]
    srcs = [("tree", ssd.SRC)] + [(d.name, d / ssd.SRC.name) for d in dirs
                                  if (d / ssd.SRC.name).exists()]
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda s: _build.build(s[1]), srcs))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda")
    x, dt, A, B, C = inputs(torch.Generator(dev).manual_seed(0), dev, *(shape[k] for k in "bshpgn"))
    if shape is not SHAPE:
        x, B, C = projection_views(x, B, C)
    args, chunk = (x, dt, A, B, C), shape["chunk"]
    wy, wst = ref.ssd_ref(*args, chunk=chunk)
    fns = []
    for (src_name, src), lib in zip(srcs, libs):
        run = runner(src, lib)
        y, st = run(*args, chunk=chunk)
        dy, ds = (y.float() - wy.float()).abs(), (st - wst).abs()
        ok = (bool((dy <= 2e-2 * (1 + wy.float().abs())).all())
              and bool((ds <= 2e-3 * (1 + wst.abs())).all()))
        print(f"  {src_name} at {shape}: max abs error y {float(dy.max()):.3e} state "
              f"{float(ds.max()):.3e} {'ok' if ok else 'MISMATCH'}")
        fns.append((src_name, lambda run=run: run(*args, chunk=chunk)))
    del wy, wst
    times = in_turns(fns)
    if shape is not SHAPE:
        times["plain"] = cuda_ms(lambda: ref.ssd_ref(*args, chunk=chunk), reps=3, warmup=1)
    kernels = {}
    for name, fn in fns:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kernels[name] = {key[:100]: ms / 20 for key, ms in _device_ms(prof)}
    print(json.dumps({"shape": shape, "ms": times, "kernel_ms": kernels}), flush=True)


if __name__ == "__main__":
    main()
