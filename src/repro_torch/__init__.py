"""PyTorch/CUDA port of the JAX package ``repro``.

Same subpackage and module names as ``repro``; imports ``torch``, numpy
and the standard library only.  The NVCache engine (``core``, ``obs``,
``storage``) is a verbatim copy with its imports renamed; the model stack
(``models``, ``kernels``, ``launch``) runs on a CUDA device unless the
caller passes ``device="cpu"``, and its attention goes through the
hand-written kernel in ``csrc/flash_attention.cu``."""
