"""setup_s: seconds from the process's start to the end of warm-up: imports,
weights drawn on the card, the kernels' builds (first run in a checkout)
and the cell's warm steps or batches."""


def read(run):
    return run["setup_s"]
