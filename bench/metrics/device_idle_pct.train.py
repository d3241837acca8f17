"""device_idle_pct.train: the share of the traced window in which no
kernel, copy or set runs on the card (the union of the profiler's device
intervals), in percent."""


def read(run):
    if run["kind"] != "train" or run["trace"] is None or not run["trace"].device:
        return None
    return 100.0 * (1.0 - run["trace"].busy_s / run["window_s"])
