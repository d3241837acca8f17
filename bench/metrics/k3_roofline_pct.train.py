"""k3_roofline_pct.train: the least time of one SSD scan a layer a step at
the cell's shape (``work.ssd.ssd_work`` at its published heads, bf16:
memory-bound at train_4k), over the device time of K3's kernels
(``csrc/ssd_scan.cu``, by name) in the traced window, in percent.  The
scans that remat runs again in the backward are kernel time, not work."""
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_work

K3 = ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd")


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not run.get("steps") or tr.device_s(K3) <= 0:
        return None
    m = run["conf"]["model"]
    di = m["ssm_expand"] * m["d_model"]
    h = di // m["ssm_head_dim"]
    t, _ = bound_s(*ssd_work(run["batch"], run["seq"], h, m["ssm_head_dim"], 1, m["ssm_state"],
                             m["ssm_chunk"], 2))
    return 100.0 * run["steps"] * m["n_layers"] * t / tr.device_s(K3)
