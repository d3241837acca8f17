"""train_mfu: the model FLOPs of the window's steps (``work.flops``: the
published sizes' products, scan and attention; backward at twice the
forward; no recomputation) over the window's seconds and the card's bf16
peak, in percent."""
from bench.work.flops import train_step_flops
from bench.work.peaks import PEAK_BF16_FLOPS


def read(run):
    if run["kind"] != "train" or not run.get("steps"):
        return None
    flops = run["steps"] * train_step_flops(run["conf"]["model"], run["batch"], run["seq"])
    return 100.0 * flops / run["window_s"] / PEAK_BF16_FLOPS
