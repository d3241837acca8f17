"""A serving cell: one closed-loop client sends batches of requests to the
program's serving entry (``launch/serve.py``: ``prefill``, then the first
token to the host, then ``decode``), each request durably logged as
accepted through NVCache before its prefill and as completed after it.

Every batch has one prompt length.  The lengths are a fixed set, the
same for every seed (``lengths``); each cycle through the set takes them
in an order drawn from the seed, so seeds change the order and the
tokens, not the work.  The window closes at the end of the first whole
cycle that ends at or after ``--seconds``, so every run serves the same
lengths.  Set-up serves one batch of each length, so the window meets no
new shape.

The check: a sample of the window's requests drawn from the seed (with a
request of the longest prompt in it) is run through the reference, and
every served token's logit is held against the reference's best at its
position; every acknowledged log line is read back."""
from __future__ import annotations

import gc
import json
import math
import time

import numpy as np
import torch

from bench.harness import durable, program
from bench.harness.tokens import zipf_tokens
from bench.reference import exact_float32
from bench.reference import serve as ref_serve
from bench.reference.weights import draw

WARM_STEP = 1 << 30      # token draws of the warm-up, apart from the window's


def lengths(traffic) -> list:
    """The prompt lengths of one cycle: ``per_cycle`` points evenly spaced
    on a log scale from prompt_min to prompt_max, both ends included,
    rounded to a multiple of ``prompt_multiple``."""
    lo, hi, k, mult = (traffic[x] for x in ("prompt_min", "prompt_max", "per_cycle",
                                            "prompt_multiple"))
    out = []
    for i in range(k):
        v = math.exp(math.log(lo) + i / (k - 1) * (math.log(hi) - math.log(lo)))
        out.append(int(min(hi, max(lo, round(v / mult) * mult))))
    return out


def length_of(traffic, seed: int, i: int) -> int:
    """The prompt length of batch ``i``."""
    ls = lengths(traffic)
    cycle, j = divmod(i, len(ls))
    order = np.random.default_rng((seed << 20) ^ (cycle + (1 << 19))).permutation(len(ls))
    return ls[order[j]]


def prompts(traffic, vocab, seed: int, i: int, P: int) -> np.ndarray:
    return zipf_tokens(seed, i, (traffic["batch"], P), vocab, traffic["zipf_a"])


def sample(records, traffic, seed: int):
    """(batch, row) of the requests the check compares: one of the longest
    prompt, then others drawn from the seed without repeats."""
    pool = [(i, r) for i, rec in enumerate(records) for r in range(traffic["batch"])]
    rng = np.random.default_rng((seed << 20) ^ ((1 << 19) - 1))
    longest = max(rec["P"] for rec in records)
    first = [p for p in pool if records[p[0]]["P"] == longest]
    pick = [first[rng.integers(len(first))]]
    rest = [p for p in pool if p != pick[0]]
    for j in rng.permutation(len(rest))[:traffic["sample_requests"] - 1]:
        pick.append(rest[j])
    return pick


def _log_line(fs, fd, off, rec):
    line = (json.dumps(rec) + "\n").encode()
    return off + fs.pwrite(fd, line, off)


def run(conf, traffic, seed, seconds, *, device, clock, profiler=None, control=None):
    """Runs the cell; returns the run record.  ``control``, when given, is
    a product (``reference.model.fp8_mm``) whose reference forward is also
    read at the sampled positions, as the control's numbers."""
    from repro_torch.launch import serve

    m = conf["model"]
    Bq, n_new = traffic["batch"], traffic["new_tokens"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    model = program.model(conf, seed, dev)
    params = model.init()
    nv, fs = durable.open_nvcache(conf["nvcache"]["serve"])
    rec = {"kind": "serve", "batches": []}
    try:
        fd = fs.open("/requests.jsonl")
        off = 0
        with torch.inference_mode():
            for j, P in enumerate(sorted(set(lengths(traffic)))):
                toks = torch.from_numpy(prompts(traffic, m["vocab"], seed, WARM_STEP + j, P)).to(dev)
                logits, cache = serve.prefill(model, params, toks, n_new)
                torch.argmax(logits[:, -1], -1).cpu()
                serve.decode(model, params, logits, cache, n_new)
                del logits, cache
            sync()
        rec["setup_s"] = time.perf_counter() - clock
        fs.window = True
        if profiler is not None:
            profiler.start()
        rec["t0_ns"] = time.time_ns()
        rec["t0"] = t_now = time.perf_counter()
        i, cycle = 0, len(lengths(traffic))
        while True:
            P = length_of(traffic, seed, i)
            toks = torch.from_numpy(prompts(traffic, m["vocab"], seed, i, P)).to(dev)
            t_sub = time.perf_counter()
            for r in range(Bq):
                off = _log_line(fs, fd, off, {"request": i * Bq + r, "prompt_len": P})
            with torch.inference_mode():
                t_pre = time.perf_counter()
                logits, cache = serve.prefill(model, params, toks, n_new)
                torch.argmax(logits[:, -1], -1).cpu()          # the first token, on the host
                t_first = time.perf_counter()
                tokens, _ = serve.decode(model, params, logits, cache, n_new)
                tokens = tokens.cpu()
                t_done = time.perf_counter()
                del logits, cache
            for r in range(Bq):
                off = _log_line(fs, fd, off, {"request": i * Bq + r, "completed": n_new})
            t_now = time.perf_counter()
            rec["batches"].append({"P": P, "ttft_s": t_first - t_sub, "prefill_s": t_first - t_pre,
                                   "decode_s": t_done - t_first, "tokens": tokens})
            i += 1
            if t_now - rec["t0"] >= seconds and i % cycle == 0:
                break
        rec["t1"] = t_now
        rec["t1_ns"] = time.time_ns()
        fs.window = False
        if profiler is not None:
            profiler.stop()
        sync()
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        rec["append_s"] = fs.append_s
        lost = fs.lost()
    finally:
        nv.shutdown()
    del model, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    exact_float32()
    ref_params = draw(m, seed, dev)
    gaps, ctl = [], []
    for i, r in sample(rec["batches"], traffic, seed):
        b = rec["batches"][i]
        prompt = torch.from_numpy(prompts(traffic, m["vocab"], seed, i, b["P"])[r]).to(dev)
        served = b["tokens"][r].to(dev)
        gaps.append(float(ref_serve.served_gaps(m, ref_params, prompt, served).max()))
        if control is not None:
            ctl.append(float(ref_serve.control_gaps(m, ref_params, prompt, served, control).max()))
    del ref_params
    rec["numbers"] = {"served_gap": (max(gaps), f"widest of {len(gaps) * n_new} served tokens"),
                      "log_lost": (lost, f"of {len(fs.acked)} lines")}
    if control is not None:
        rec["control"] = {"served_gap": (max(ctl), f"widest of {len(ctl) * n_new} positions")}
    rec["check_s"] = time.perf_counter() - t_check
    rec["attempted"] = len(rec["batches"]) * Bq
    rec["failed"] = 0
    return rec


# ---- what the metric readers read

def requests(rec):
    """(ttft seconds, tokens) of every request in the window."""
    return [(b["ttft_s"], b["P"] + len(b["tokens"][0])) for b in rec["batches"]
            for _ in range(len(b["tokens"]))]

