"""Plain PyTorch reference of the benchmark's configurations, in float32
with TF32 off; imports nothing of the program and takes nothing it made."""
import torch


def exact_float32() -> None:
    """Keep float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
