"""Planted faults of the ``pattern`` family's MoE path, read through a whole
run of a cell (``bench.run.measure``), to hold them against the limit of
``correct``:

* ``left_out``: every MoE block computes its shared expert alone, the
  routed experts' part left out;
* ``off_by_one``: each (token, k) pair runs on the expert one over the one
  its router chose (router expert e + 1 for e, the last wrapping to 0).

    python bench/harness/pattern_faults.py --workload <name> --seeds 1,2,3 \\
        --fault left_out|off_by_one|none [--routed-write 0.1]

prints one JSON line a seed.  ``none`` plants nothing (a sound run).
``--routed-write`` draws the routed experts' down projections at that
extra scale in place of ``bench/families/pattern.py``'s ``ROUTED_WRITE``,
in the program and the reference alike, to read a weight draw before it
is chosen.  Needs a CUDA card at a cell's size."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = ("none", "left_out", "off_by_one")


def plant(fault: str):
    """Plants ``fault`` in the program's dropless MoE path (module state,
    for the rest of the process)."""
    from repro_torch.models import moe

    if fault == "left_out":
        def shared_only(cfg, p, x):
            B, S, d = x.shape
            xt = x.reshape(B * S, d)
            return moe._relu2(xt, p["shared_wu"], p["shared_wd"]).view(B, S, d)

        moe._moe_dropless = shared_only
    elif fault == "off_by_one":
        route = moe._route_sigmoid

        def one_over(cfg, p, xt):
            w, idx = route(cfg, p, xt)
            return w, (idx + 1) % cfg.n_router

        moe._route_sigmoid = one_over


def draw_routed_at(scale: float):
    """Makes the ``pattern`` family's module, each time the harness loads it,
    draw the routed experts' down projections at ``scale``."""
    from bench import families

    load = families.load

    def load_at(family, directory=families.HERE):
        mod = load(family, directory)
        if family == "pattern":
            mod.ROUTED_WRITE = scale
        return mod

    families.load = load_at


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--routed-write", type=float, default=None)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run

    plant(args.fault)
    if args.routed_write is not None:
        draw_routed_at(args.routed_write)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.measure(args.workload, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "routed_write": args.routed_write, "correct": out["correct"],
                          "numbers": {k: list(v) for k, v in out["_numbers"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
