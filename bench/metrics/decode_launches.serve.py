"""decode_launches.serve: the host's CUDA calls that start device work
(``harness.spans.LAUNCHES``: kernel launches, copies, sets, a graph's
replay as one) that begin inside the window's ``serve.decode_step`` ranges,
over the number of those ranges: launches a decode step."""
from bench.harness import spans

SPAN = "serve.decode_step"


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or tr is None:
        return None
    steps = spans.named(tr, SPAN)
    if not steps:
        return None
    return spans.starting_in(tr, steps, spans.LAUNCHES) / len(steps)
