"""K2, int8 group quantization: the port's CPU path of ``ops.quantize``
against the Pallas kernel (interpret mode) and the JAX oracle on the cases
of ``tests/test_kernels.py`` plus an all-zero group and exact .5 ties,
``compress_tree`` against the JAX package's, and, on a CUDA card, the
hand-written kernel against its plain version.

Tolerance: none against the JAX oracle ``quantize_ref``: q and the scales
are equal bit for bit (a true float32 division, round half to even), as
they are between the port's two routes.  The Pallas kernel, traced under
``jit``, gets ``amax * (1/127)`` from XLA for ``amax / 127`` (one ulp off
in some scales), so against it the scales are held to the JAX suite's
rtol 1e-6 (``tests/test_kernels.py:80-81``), q exactly in every group
whose scale is the oracle's, and to 1 in the others (a bfloat16 value over
a scale one ulp off can cross a .5 tie).

JAX is imported inside the ``jx`` fixture, not at the top: the kernel
tests need none, and on the card they run alone
(``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quantize.py -k card``)."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.optim import grad_compress

CASES = [((64, 512), 256), ((3, 5, 256), 128), ((1024,), 256)]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.quantize import quantize_pallas
    from repro.optim import grad_compress as jgc
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, ref=jref, pallas=quantize_pallas,
                                 gc=jgc)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _input(shape, group, seed=0):
    """Normal values times 3, the first group all zero and, where there is
    room, a second group of exact .5 ties (amax 127, so scale 1 and
    x / scale lands on k + 0.5)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1)
    flat[:group] = 0
    if flat.size >= 2 * group:
        tie = np.arange(group, dtype=np.float32) % 7 - 3.5
        tie[0] = 127
        flat[group:2 * group] = tie
    return x


def _as(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape,group", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_path_matches_pallas_and_oracle(jx, shape, group, dtype):
    x = _input(shape, group)
    jxa = jx.jnp.asarray(x).astype(dtype)
    q, s = ops.quantize(_as(x, dtype), group=group)
    assert q.dtype == torch.int8 and q.shape == shape
    assert s.dtype == torch.float32 and s.shape == (*shape[:-1], shape[-1] // group)
    wq, ws = jx.ref.quantize_ref(jxa, group=group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    pq, ps = (np.asarray(a) for a in jx.pallas(jxa, group=group, blk_r=16, interpret=True))
    np.testing.assert_allclose(s.numpy(), ps, rtol=1e-6)
    same = np.repeat(s.numpy() == ps, group, axis=-1)
    dq = np.abs(q.numpy().astype(np.int32) - pq)
    assert (dq[same] == 0).all() and (dq <= 1).all()
    flat_s = s.reshape(-1)
    assert float(flat_s[0]) == 1.0 and bool((q.reshape(-1)[:group] == 0).all())


def test_ties_round_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]])
    q, s = ops.quantize(x, group=8)
    assert float(s[0, 0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


def test_dequantize_inverts_within_half_a_step(jx):
    x = torch.from_numpy(_input((8, 512), 256, seed=3))
    q, s = ops.quantize(x, group=256)
    back = ops.dequantize(q, s, group=256)
    want = jx.ref.dequantize_ref(jx.jnp.asarray(q.numpy()), jx.jnp.asarray(s.numpy()),
                                 group=256)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    step = s.repeat_interleave(256, -1)
    assert bool(((back - x).abs() <= step / 2 + 1e-6).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_tree_matches_jax(jx, dtype):
    """Leaves whose size is and is not a multiple of the group (padding),
    nested as a parameter tree is."""
    rng = np.random.default_rng(7)
    tree = {"embed": rng.standard_normal((40, 16)), "norm": rng.standard_normal((16,)),
            "layers": {"w": rng.standard_normal((2, 16, 24)) * 1e-3,
                       "b": np.zeros((3, 5))}}
    tree = jx.jax.tree.map(lambda a: a.astype(np.float32), tree)
    want = jx.gc.compress_tree(jx.jax.tree.map(lambda a: jx.jnp.asarray(a).astype(dtype), tree),
                               group=256)
    got = grad_compress.compress_tree(jx.jax.tree.map(lambda a: _as(a, dtype), tree),
                                      group=256)
    for a, b in zip(jx.jax.tree.leaves(jx.jax.tree.map(lambda t: t.float().numpy(), got)),
                    jx.jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        quantize_cuda(torch.zeros(256), group=256)


# ----------------------------------------------------------- on the card

@pytest.mark.parametrize("shape,group", CASES + [((5, 96), 96), ((2, 36), 12),
                                                 ((1000, 2048), 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_card(cuda, shape, group, dtype):
    x = _as(_input(shape, group), dtype).to(cuda)
    before = quantize_cuda.launches
    q, s = quantize_cuda(x, group=group)
    torch.cuda.synchronize()
    assert quantize_cuda.launches == before + 1
    wq, ws = tref.quantize_ref(x, group=group)
    assert torch.equal(q, wq) and torch.equal(s, ws)


def test_kernel_reads_misaligned_and_refuses_strided_on_card(cuda):
    """A view at a 4-byte offset (not 16-byte aligned) takes the scalar
    loads; a strided view is refused."""
    base = _as(_input((1, 1028), 4), "float32").to(cuda)
    x = base[0, 1:1025]
    q, s = quantize_cuda(x, group=256)
    wq, ws = tref.quantize_ref(x, group=256)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_cuda(base.reshape(4, 257)[:, :256], group=256)
