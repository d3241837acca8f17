"""k3_roofline_pct.serve: the least time of the model's SSD scans a
prefill (``work.ssd.ssd_work`` for each of the family's ``ssd_scans``, its
layers times one scan at the batch, the prompt length and the published
heads and groups, bf16), summed over the window's prefills, over the
device time of K3's kernels (``csrc/ssd_scan.cu``, by name) in the traced
window, in percent.  Decode runs no K3.  None for a model without an SSD
scan."""
from bench import families
from bench.work.peaks import bound_s
from bench.work.ssd import ssd_work

K3 = ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd")


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or tr is None or not run["batches"] or tr.device_s(K3) <= 0:
        return None
    m = run["conf"]["model"]
    scans = families.of(m).ssd_scans(m)
    if not scans:
        return None
    pct = sum(100.0 * layers * sum(bound_s(*ssd_work(len(b["tokens"]), b["P"], h, p, g, n,
                                                      chunk, 2))[0] for b in run["batches"])
              for layers, h, p, g, n, chunk in scans)
    return pct / tr.device_s(K3)
