"""k3_bwd_roofline_pct.train: the least time of the model's SSD backwards
a step at the cell's shape (``work.ssd.ssd_bwd_work`` for each of the
family's ``ssd_scans``, its layers times one backward, bf16, the final
state unused), over the device time of K3's backward kernels
(``csrc/ssd_scan_bwd.cu``, both routes and their casts, by name) in the
traced window, in percent.  None for a model without an SSD scan."""
from bench import families
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_bwd_work

K3B = ("ssd_bwd_state", "ssd_bwd_split_carry", "ssd_bwd_tiles", "ssd_bwd_dc",
       "ssd_bwd_carry", "ssd_bwd_chunk", "cast_rows")


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not run.get("steps") or tr.device_s(K3B) <= 0:
        return None
    m = run["conf"]["model"]
    scans = families.of(m).ssd_scans(m)
    if not scans:
        return None
    pct = sum(100.0 * run["steps"] * layers
              * bound_s(*ssd_bwd_work(run["batch"], run["seq"], h, p, g, n, chunk, 2))[0]
              for layers, h, p, g, n, chunk in scans)
    return pct / tr.device_s(K3B)
