"""loop_gap_ms.train: the window's idle device time outside its
``train.step`` ranges (``train/loop.py``: the batch's draw and copy, the
durable metrics line, the caller's heartbeat), over the window's steps, in
ms a step."""
from bench.harness import spans

SPAN = "train.step"


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not run.get("steps"):
        return None
    steps = spans.named(tr, SPAN)
    if not steps:
        return None
    idle = sum(e - s for s, e in tr.gaps()) - spans.idle_ns(tr, steps)
    return idle / 1e6 / run["steps"]
