"""k3_roofline_pct.serve: the least time of one SSD scan a layer a prefill
(``work.ssd.ssd_work`` at the batch, the prompt length and the published
heads, bf16), summed over the window's prefills, over the device time of
K3's kernels (``csrc/ssd_scan.cu``, by name) in the traced window, in
percent.  Decode runs no K3."""
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_work

K3 = ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd")


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or tr is None or not run["batches"] or tr.device_s(K3) <= 0:
        return None
    m = run["conf"]["model"]
    di = m["ssm_expand"] * m["d_model"]
    h = di // m["ssm_head_dim"]
    t = sum(bound_s(*ssd_work(len(b["tokens"]), b["P"], h, m["ssm_head_dim"], 1, m["ssm_state"],
                              m["ssm_chunk"], 2))[0] for b in run["batches"])
    return 100.0 * m["n_layers"] * t / tr.device_s(K3)
