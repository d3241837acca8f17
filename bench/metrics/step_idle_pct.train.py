"""step_idle_pct.train: the share of the window's ``train.step`` ranges
(``train/loop.py``: a step from its call until the host has read its
metrics, so the wait for the device is in it) in which no kernel, copy or
set runs on the card, in percent: host work inside the step that the
device waits for (remat's dispatch, Python)."""
from bench.harness import spans

SPAN = "train.step"


def read(run):
    if run["kind"] != "train" or run["trace"] is None:
        return None
    return spans.idle_pct(run["trace"], SPAN)
