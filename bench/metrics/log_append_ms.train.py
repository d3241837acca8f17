"""log_append_ms.train: the mean time of one acknowledged pwrite through
NVCacheFS in the window (the benchmark's timer around the file system it
hands the program: the train cell's metrics lines)."""


def read(run):
    if run["kind"] != "train" or not run["append_s"]:
        return None
    return 1e3 * sum(run["append_s"]) / len(run["append_s"])
