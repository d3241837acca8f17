"""train_tokens_per_s: the tokens of every step the window completed, over
the window's seconds (each step ends with its metrics line durable)."""
from bench.harness.stats import rate


def read(run):
    if run["kind"] != "train" or not run.get("steps"):
        return None
    return rate(run["steps"] * run["batch"] * run["seq"], run["t0"], run["t1"])
