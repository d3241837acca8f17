"""Published peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense,
at its 700 W limit)."""
PEAK_BF16_FLOPS = 989e12      # tensor cores, bf16 / fp16
PEAK_BYTES = 3.35e12          # HBM3


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(seconds, "compute" or "memory"): the larger of the two least times."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")
