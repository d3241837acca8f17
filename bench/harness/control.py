"""Readings that set the limits of ``correct``, at a cell's own size:

* ``program``: the numbers of sound runs of the program, one a seed, all
  in one process (a short window each; training's numbers need none);
* ``control``: the reference put in the program's place and computed in
  the precision below the configuration's bfloat16 (float8 e4m3 products,
  ``reference.model.fp8_mm``), held against the float32 reference;
* ``half_batch`` (training): the reference put in the program's place
  with half of each batch left out, the mean taken over the rest.

    python bench/harness/control.py --workload <name> --seeds 1,2,3 --mode program|control

prints one JSON line a seed.  Needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def train_control(conf, traffic, seed, device):
    """{"control": numbers, "half_batch": numbers} of one seed."""
    import torch

    from bench.harness import check
    from bench.harness.tokens import SyntheticTokens
    from bench.reference import exact_float32
    from bench.reference import model as ref_model
    from bench.reference import train as ref_train

    exact_float32()
    m, B = conf["model"], conf["train_batch"]
    pipe = SyntheticTokens(m["vocab"], B, traffic["seq"], seed=seed, a=traffic["zipf_a"])
    batches = [torch.from_numpy(pipe.batch_at(i)).to(device)
               for i in range(traffic["checked_steps"])]
    args = (m, conf["optimizer"], conf["compress_group"], seed, batches, device)
    kw = {"row_block": traffic["ref_row_block"]}
    ref = ref_train.readings(*args, **kw)
    out = {}
    for name, extra in (("control", {"mm": ref_model.fp8_mm}),
                        ("half_batch", {"rows": slice(0, B // 2)})):
        got = ref_train.readings(*args, **kw, **extra)
        out[name] = {k: list(v) for k, v in check.train_numbers(got, ref).items()}
        del got
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import run
    from bench.harness import manifest
    from bench.reference import model as ref_model

    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    conf, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "seed": seed, "mode": args.mode}
        if args.mode == "control" and traffic["kind"] == "train":
            line.update(train_control(conf, traffic, seed, torch.device("cuda")))
        else:
            ctl = ref_model.fp8_mm if args.mode == "control" else None
            out = run.measure(args.workload, seed, args.seconds, False, control=ctl)
            line.update(correct=out["correct"], metrics=out["metrics"],
                        numbers={k: list(v) for k, v in out["_numbers"].items()})
            if "_control" in out:
                line["control"] = out["_control"]
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
