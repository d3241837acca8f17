"""metrics_log_ms.train: the mean ``train.log`` range in the window
(``train/loop.py``: one step's metrics line made durable through the file
system the loop is given), in ms: the program's own measure of what
``log_append_ms.train`` times from outside, with the line's encoding."""
from bench.harness import spans

SPAN = "train.log"


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None:
        return None
    logs = spans.named(tr, SPAN)
    if not logs:
        return None
    return sum(e - s for s, e in logs) / 1e6 / len(logs)
