"""moe_idle_pct.serve: the share of the window's ``moe.layer`` ranges
(``models/moe.py``'s dropless path: routing, dispatch, the held experts'
grouped products, combine and the shared expert; a prefill's, since a
decode step replays a CUDA graph and opens no range) in which no kernel,
copy or set runs on the card, in percent: a host sync in the dispatch
shows here first.  None where the window holds no such range."""
from bench.harness import spans

SPAN = "moe.layer"


def read(run):
    if run["kind"] != "serve" or run["trace"] is None:
        return None
    return spans.idle_pct(run["trace"], SPAN)
