"""decode_step_ms: all decode time in the window over all decode steps
(``launch/serve.py`` ``decode``: one ``decode_step`` a new token)."""


def read(run):
    if run["kind"] != "serve" or not run["batches"]:
        return None
    steps = sum(len(b["tokens"][0]) for b in run["batches"])
    return 1e3 * sum(b["decode_s"] for b in run["batches"]) / steps
