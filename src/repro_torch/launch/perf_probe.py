"""Count one cell with config overrides, the committed configs untouched:
the port of ``scripts/perf_probe.py``.

    python -m repro_torch.launch.perf_probe llama3.2-1b train_4k remat=none [--mesh single|1x1]

The cell runs through the dry run's mesh mode (``launch/dryrun.py``, on
``meta`` in a fake world of 256 ranks; ``--mesh 1x1``: one device) with
``dataclasses.replace(config, **overrides)``, each ``k=v`` parsed as the
JAX script parses it (an int, a float, else the string).  It prints the
three roofline terms of one device (``launch/roofline.py``, H100
constants) and ``work_flops``.  Like the JAX script's, train and prefill
cells only.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, roofline


def parse_overrides(items) -> dict:
    """{k: v} of ``k=v`` strings: ``v`` an int, a float, else as given."""
    out = {}
    for kv in items:
        k, v = kv.split("=")
        out[k] = v if not v.replace(".", "").lstrip("-").isdigit() else (
            int(v) if "." not in v else float(v))
    return out


def probe(arch: str, shape_name: str, *, mesh: str = "single", **overrides) -> dict:
    """The record of ``arch`` at ``shape_name`` with ``overrides`` on the
    ``mesh`` ("single" or "1x1"), with its roofline terms."""
    if SHAPES[shape_name].kind not in ("train", "prefill"):
        raise SystemExit("probe supports train/prefill")
    cfg = dataclasses.replace(get_config(arch), **overrides)
    rec = next(dryrun.run_cells(mesh, [(arch, shape_name)], device="cpu", cfg=cfg))
    if rec["status"] != "ok":
        raise RuntimeError(f"{arch} {shape_name} {overrides}: {rec.get('error', rec['status'])}")
    rec.update(roofline.terms(rec))
    print(f"{arch} {shape_name} {overrides} on {rec['mesh']}: "
          f"t=({rec['t_compute']:.3f},{rec['t_memory']:.3f},{rec['t_collective']:.3f})s "
          f"work_flops={rec['work_flops']:.3e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("overrides", nargs="*", help="config fields as k=v")
    ap.add_argument("--mesh", default="single", choices=("single", "1x1"))
    args = ap.parse_args(argv)
    probe(args.arch, args.shape, mesh=args.mesh, **parse_overrides(args.overrides))
    return 0


if __name__ == "__main__":
    sys.exit(main())
