"""log_append_ms.serve: the mean time of one acknowledged pwrite through
NVCacheFS in the window (the benchmark's timer around the file system it
hands the program: the serve cell's request log lines)."""


def read(run):
    if run["kind"] != "serve" or not run["append_s"]:
        return None
    return 1e3 * sum(run["append_s"]) / len(run["append_s"])
