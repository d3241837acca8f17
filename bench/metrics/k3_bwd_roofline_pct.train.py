"""k3_bwd_roofline_pct.train: the least time of one SSD backward a layer a
step at the cell's shape (``work.ssd.ssd_bwd_work``, bf16, the final state
unused), over the device time of K3's backward kernels
(``csrc/ssd_scan_bwd.cu``, both routes and their casts, by name) in the
traced window, in percent."""
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_bwd_work

K3B = ("ssd_bwd_state", "ssd_bwd_split_carry", "ssd_bwd_tiles", "ssd_bwd_dc",
       "ssd_bwd_carry", "ssd_bwd_chunk", "cast_rows")


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not run.get("steps") or tr.device_s(K3B) <= 0:
        return None
    m = run["conf"]["model"]
    di = m["ssm_expand"] * m["d_model"]
    h = di // m["ssm_head_dim"]
    t, _ = bound_s(*ssd_bwd_work(run["batch"], run["seq"], h, m["ssm_head_dim"], 1,
                                 m["ssm_state"], m["ssm_chunk"], 2))
    return 100.0 * run["steps"] * m["n_layers"] * t / tr.device_s(K3B)
