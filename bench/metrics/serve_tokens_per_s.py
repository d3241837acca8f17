"""serve_tokens_per_s: prompt and generated tokens of every request the
window completed, over the window's seconds."""
from bench.harness.serve_cell import requests
from bench.harness.stats import rate


def read(run):
    if run["kind"] != "serve" or not run["batches"]:
        return None
    return rate(sum(n for _, n in requests(run)), run["t0"], run["t1"])
