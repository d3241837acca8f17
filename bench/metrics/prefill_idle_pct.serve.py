"""prefill_idle_pct.serve: the share of the window's ``serve.prefill``
ranges (``launch/serve.py`` ``prefill``: the host's launch of a batch's
prefill) in which no kernel, copy or set runs on the card, in percent."""
from bench.harness import spans

SPAN = "serve.prefill"


def read(run):
    if run["kind"] != "serve" or run["trace"] is None:
        return None
    return spans.idle_pct(run["trace"], SPAN)
