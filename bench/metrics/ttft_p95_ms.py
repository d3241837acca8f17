"""ttft_p95_ms: the 95th percentile (nearest rank) over every request of
the window of the time from its submission, before its durable "accepted"
line, to its first token on the host."""
from bench.harness.serve_cell import requests
from bench.harness.stats import percentile


def read(run):
    if run["kind"] != "serve" or not run["batches"]:
        return None
    return 1e3 * percentile([t for t, _ in requests(run)], 95)
