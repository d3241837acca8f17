"""Operations and bytes of one SSD scan and of its backward: frozen copies
of the program's ``launch/roofline.py`` ``ssd_work`` and ``ssd_bwd_work``.

Worked example, mamba2-780m's train_4k call (b 8, s 4096, h 48, p 64,
g 1, n 128, chunk 256, bf16)::

    >>> ssd_work(8, 4096, 48, 64, 1, 128, 256, 2)
    (78488010752, 438304960)
    >>> ssd_bwd_work(8, 4096, 48, 64, 1, 128, 256, 2)
    (285149757440, 650117504)

so the forward is bound by its bytes, 130.8 us at 3.35 TB/s, and the
backward by its operations, 288.3 us at 989 TFLOP/s.
"""
from __future__ import annotations


def ssd_work(b, s, h, p, g, n, chunk, itemsize):
    """(operations, bytes) of one SSD scan.  Operations: C B^T over each
    chunk's causal triangle once per (batch, group, chunk), then per
    (batch * head, chunk) (C B^T . L)(x dt) over the triangle, C S^T and
    the state update.  Bytes: x, dt (f32), A, B, C read once, y and the
    final f32 state written once."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = b * g * nc * 2 * tri * n + b * h * nc * (2 * tri * p + 2 * 2 * chunk * p * n)
    nbytes = (2 * b * s * h * p * itemsize + 4 * b * s * h + 4 * h
              + 2 * b * s * g * n * itemsize + 4 * b * h * p * n)
    return flops, nbytes


def ssd_bwd_work(b, s, h, p, g, n, chunk, itemsize, final_grad=False):
    """(operations, bytes) of one SSD backward.  Operations: C B^T over each
    chunk's causal triangle once per (batch, group, chunk); then per
    (batch * head, chunk), over the triangle, M = dy (x dt)^T, d(x dt) =
    (G L)^T dy, dC = (L M) B and dB = (L M)^T C, and five (chunk, p, n)
    products.  Bytes: x, dt (f32), A, B, C and dy (and the final state's
    f32 gradient when it is given) read once; dx, ddt (f32), dA, dB and dC
    written once."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = (b * g * nc * 2 * tri * n
             + b * h * nc * (2 * tri * (2 * p + 2 * n) + 5 * 2 * chunk * p * n))
    nbytes = (3 * b * s * h * p * itemsize + 2 * 4 * b * s * h + 2 * 4 * h
              + 4 * b * s * g * n * itemsize + (4 * b * h * p * n if final_grad else 0))
    return flops, nbytes
