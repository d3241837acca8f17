"""decode_idle_pct.serve: the share of the window's ``serve.decode_step``
ranges (``launch/serve.py`` ``decode``: one generated token, its argmax
and the model's decode step) in which no kernel, copy or set runs on the
card, in percent: how far the host's dispatch paces decode."""
from bench.harness import spans

SPAN = "serve.decode_step"


def read(run):
    if run["kind"] != "serve" or run["trace"] is None:
        return None
    return spans.idle_pct(run["trace"], SPAN)
