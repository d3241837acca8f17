"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card it is started on:
set-up (weights drawn on the card from the seed, the cell's shapes
warmed), a measured window of ``--seconds``, then the check that decides
``correct``.  The last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read in a window
under the profiler), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit.  Exits non-zero and
prints no result without a CUDA card, with fewer cards than the cell
asks for, or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

CLOCK = time.perf_counter()          # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def measure(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
            root: Path = ROOT, control=None) -> dict:
    """Runs the cell; returns the result object, ``checks`` last.  The
    tests call this with ``device="cpu"`` to drive a run without a card."""
    import torch

    from bench.harness import check, manifest, serve_cell, train_cell
    from bench.harness.trace import Trace

    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    conf = manifest.config(cell["config"], root / "bench")
    traffic = manifest.traffic(cell["traffic"], root / "bench")
    manifest.family(conf["model"], root / "bench")
    driver = {"train": train_cell, "serve": serve_cell}[traffic["kind"]]
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
    kw = {"control": control} if control is not None else {}
    rec = driver.run(conf, traffic, seed, seconds, device=device, clock=CLOCK, profiler=prof, **kw)
    rec.update(workload=workload, conf=conf, traffic=traffic, window_s=rec["t1"] - rec["t0"])
    t_trace = time.perf_counter()
    rec["trace"] = Trace(prof, rec["t0_ns"], rec["t1_ns"]) if prof is not None else None
    print(f"bench: set-up {rec['setup_s']:.2f} s, window {rec['window_s']:.2f} s, check "
          f"{rec['check_s']:.2f} s, trace read {time.perf_counter() - t_trace:.2f} s",
          file=sys.stderr)
    wanted = manifest.per_layer(man, workload) if trace else manifest.end_to_end(man, workload)
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], root / "bench")(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": None, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        dev["busy_s"] = rec["trace"].busy_s
        dev["window_s"] = rec["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"].top_device_ops(),
                            "idle_gaps": rec["trace"].idle_gaps()}
    out["correct"], out["checks"] = check.verdict(rec["numbers"], conf["limits"][traffic["kind"]])
    out["_numbers"] = rec["numbers"]
    if "control" in rec:
        out["_control"] = rec["control"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import manifest
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    numbers = out.pop("_numbers")
    out.pop("_control", None)
    bad = forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, (value, detail) in numbers.items():
        if name not in out["checks"]:
            print(f"reading {name} = {value!r} (not compared; {detail})", file=sys.stderr)
    for name, c in out["checks"].items():
        detail = numbers.get(name, (None, ""))[1]
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}; {detail})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
