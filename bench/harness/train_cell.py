"""A training cell: the program's own training loop (``train/loop.py``)
over the traffic's token batches, each step's metrics line made durable
through NVCache, no checkpoint.  The first ``warm_steps`` steps are set-up
(the first builds the kernels); the window then runs whole steps until
``seconds`` have passed, and closes through the loop's ``heartbeat`` hook.

The check: the program's first ``checked_steps`` steps (fewer than the
warm steps, so that the reference takes less time than the window) are
held against the reference's, from the same weights and batches
(``check.train_numbers``), and every acknowledged metrics line is read
back."""
from __future__ import annotations

import gc
import json
import time

import torch

from bench.harness import check, durable, program
from bench.harness.tokens import SyntheticTokens
from bench.reference import exact_float32
from bench.reference import train as ref_train
from bench.reference.weights import draw_leaf, flat_items


class WindowClosed(Exception):
    pass


def _losses(fs, n: int):
    """The loss of each of the first ``n`` steps, from the metrics lines
    the program acknowledged (the check reads them back first)."""
    out = {}
    for _, _, data in fs.acked:
        for line in data.decode().splitlines():
            rec = json.loads(line)
            if "loss" in rec and rec["step"] < n:
                out[rec["step"]] = rec["loss"]
    return [out[i] for i in sorted(out)]


def program_gradient(opt, conf):
    """The program's first gradient as its optimizer got it, by leaf, on
    the host: the first moment after one step over 1 - b1."""
    b1 = conf["optimizer"]["b1"]
    return {k: (m / (1 - b1)).to("cpu") for k, m in flat_items(opt.state["m"])}


def change_readings(opt, conf, seed, device):
    """Each leaf's weights minus the seed's initial draw, by norm."""
    return {k: float(torch.linalg.vector_norm(p - draw_leaf(conf["model"], seed, k, device)))
            for k, p in flat_items(opt.params)}


def run(conf, traffic, seed, seconds, *, device, clock, profiler=None):
    """Runs the cell; returns the run record the metric readers and the
    result line read.  ``clock`` is the process's start on
    ``time.perf_counter``; ``profiler`` a started-on-demand profiler for a
    traced window, or None."""
    from repro_torch.train import loop

    B, S, warm = conf["train_batch"], traffic["seq"], traffic["warm_steps"]
    checked = traffic["checked_steps"]
    m = conf["model"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model = program.model(conf, seed, dev)
    opt = program.HeldOptimizer(conf["optimizer"])
    pipe = SyntheticTokens(m["vocab"], B, S, seed=seed, a=traffic["zipf_a"])
    nv, fs = durable.open_nvcache(conf["nvcache"]["train"])
    rec = {"kind": "train", "batch": B, "seq": S}

    def heartbeat(step):
        if step == 0:
            rec["grad"] = program_gradient(opt, conf)
        if step == checked - 1:
            rec["change_norm"] = change_readings(opt, conf, seed, dev)
        if step == warm - 1:
            sync()
            rec["setup_s"] = time.perf_counter() - clock
            fs.window = True
            if profiler is not None:
                profiler.start()
            rec["t0_ns"] = time.time_ns()
            rec["t0"] = time.perf_counter()
        elif step >= warm:
            rec["steps"] = step + 1 - warm
            if time.perf_counter() - rec["t0"] >= seconds:
                rec["t1"] = time.perf_counter()
                rec["t1_ns"] = time.time_ns()
                fs.window = False
                if profiler is not None:
                    profiler.stop()
                raise WindowClosed

    try:
        try:
            loop.train(model, opt, pipe, fs, total_steps=1 << 40, ckpt_every=1 << 40,
                       seed=seed, heartbeat=heartbeat, compress_grads=True, device=dev)
        except WindowClosed:
            pass
        sync()
        rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
        rec["append_s"] = fs.append_s
        lost = fs.lost()
        grad = rec.pop("grad")
        prog = {"loss": _losses(fs, checked), "grad": grad, "change_norm": rec.pop("change_norm"),
                "grad_norm": {k: float(torch.linalg.vector_norm(g)) for k, g in grad.items()}}
    finally:
        nv.shutdown()
    opt.release()
    del model, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    exact_float32()
    batches = [torch.from_numpy(pipe.batch_at(i)).to(dev) for i in range(checked)]
    ref = ref_train.readings(m, conf["optimizer"], conf["compress_group"], seed, batches, dev,
                             row_block=traffic["ref_row_block"])
    numbers = check.train_numbers(prog, ref)
    numbers["log_lost"] = (lost, f"of {len(fs.acked)} lines")
    rec["numbers"] = numbers
    rec["check_s"] = time.perf_counter() - t_check
    rec["attempted"] = rec.get("steps", 0)
    rec["failed"] = 0
    return rec
