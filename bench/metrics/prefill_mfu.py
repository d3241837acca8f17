"""prefill_mfu: the model FLOPs of every prefill in the window
(``work.flops.forward_flops`` at its batch and prompt length, the
unembedding at each prompt's last position only) over the
summed wall time of those prefills (each to its first token on the host)
and the card's bf16 peak, in percent."""
from bench.work.flops import forward_flops
from bench.work.peaks import PEAK_BF16_FLOPS


def read(run):
    if run["kind"] != "serve" or not run["batches"]:
        return None
    m = run["conf"]["model"]
    flops = sum(forward_flops(m, len(b["tokens"]), b["P"], unembed_all=False) for b in run["batches"])
    return 100.0 * flops / sum(b["prefill_s"] for b in run["batches"]) / PEAK_BF16_FLOPS
