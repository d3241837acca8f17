"""k3_roofline_pct.train: the least time of the model's SSD scans a step at
the cell's shape (``work.ssd.ssd_work`` for each of the family's
``ssd_scans``, its layers times one scan at its published heads and
groups, bf16: memory-bound at train_4k), over the device time of K3's
kernels (``csrc/ssd_scan.cu``, by name) in the traced window, in percent.
The scans that remat runs again in the backward are kernel time, not
work.  None for a model without an SSD scan."""
from bench import families
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_work

K3 = ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd")


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not run.get("steps") or tr.device_s(K3) <= 0:
        return None
    m = run["conf"]["model"]
    scans = families.of(m).ssd_scans(m)
    if not scans:
        return None
    pct = sum(100.0 * run["steps"] * layers
              * bound_s(*ssd_work(run["batch"], run["seq"], h, p, g, n, chunk, 2))[0]
              for layers, h, p, g, n, chunk in scans)
    return pct / tr.device_s(K3)
