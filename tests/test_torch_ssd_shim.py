"""K3's CUDA sources, the forward on both routes and the backward, built
with g++ against a CPU emulation of CUDA and of ``csrc/hopper.cuh``
(``tests/cuda_shim``, built by its ``emulate.py``) and held against the
plain ``ssd_ref`` and autograd through it on CPU tensors: the indexing, the
128-byte swizzle, the wgmma descriptors (K-major and MN-major A and B, A
from registers), the chunk-parallel split and the hi/lo precision plan of
the forward, and the backward's chunk states, reverse carry, tile pairs,
atomics and suffix sums on both its routes (the wgmma route's key and
query tile blocks over a slice of a group's heads, its hi + lo plan and
its dc pass), run as the card runs them, only slowly.  What the emulation
cannot show is whether the card reads descriptors this way, nor speed: the
card tests in ``test_torch_ssd.py`` do that.

Tolerances as there: y 2e-3 (f32) / 2e-2 (bf16), state 2e-3, all
·(1+|ref|); the backward's gradients the same, but dA, a sum over every
(batch, step), by ||d|| / ||ref|| <= 1e-3 (f32) / 1e-2 (bf16).  Shapes stay
at a few hundred rows: the emulation runs one thread per CUDA thread and
the blocks one after another."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cuda_shim import emulate
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    # one directory per session: workers share nothing
    return ssd.load(emulate.build(ssd.SRC, tmp_path_factory.mktemp("shim")))


@pytest.fixture(scope="module")
def bwd_entry(tmp_path_factory):
    return ssd.load_bwd(emulate.build(ssd.BWD_SRC, tmp_path_factory.mktemp("shim_bwd")))


def _close(got, want, tol):
    """|got - want| <= tol·(1+|want|)."""
    np.testing.assert_allclose(got.detach().float().numpy(), want.detach().float().numpy(),
                               rtol=tol, atol=tol)


CASES = [  # (b, s, h, p, g, n, chunk, dtype, layout, A scale)
    (1, 128, 2, 64, 1, 128, 64, "bfloat16", "contiguous", 1.0),
    (1, 256, 2, 64, 1, 128, 128, "bfloat16", "contiguous", 1.0),
    (1, 256, 2, 64, 2, 128, 128, "bfloat16", "contiguous", 1.0),
    (1, 192, 1, 64, 1, 48, 64, "bfloat16", "contiguous", 1.0),
    (1, 256, 1, 64, 1, 96, 256, "bfloat16", "contiguous", 1.0),
    (1, 256, 3, 64, 1, 128, 128, "bfloat16", "projection", 1.0),
    # hymba-1.5b's state 16: the carry's grid, C·Sᵀ's k loop and the state
    # stores at their least
    (1, 256, 3, 64, 1, 16, 128, "bfloat16", "projection", 1.0),
    (1, 256, 2, 64, 1, 128, 128, "bfloat16", "contiguous", 8.0),
    (1, 64, 2, 16, 2, 16, 16, "float32", "contiguous", 1.0),
    (1, 64, 2, 16, 2, 16, 16, "bfloat16", "contiguous", 1.0),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,layout,scale", CASES)
def test_emulated_kernel_matches_plain(entry, b, s, h, p, g, n, chunk, dtype, layout, scale):
    rng = np.random.default_rng(0)
    normal = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    cdt = getattr(torch, dtype)
    if layout == "projection":   # views of one projection row, as ssm_forward hands them over
        xbc = normal(b, s, h * p + 2 * g * n).to(cdt)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        x, B, C = normal(b, s, h, p).to(cdt), normal(b, s, g, n).to(cdt), normal(b, s, g, n).to(cdt)
    dt = F.softplus(normal(b, s, h))
    A = -normal(h).exp() * scale
    route, y, st = ssd.launch(entry, x, dt, A, B, C, chunk, None)   # the shim has no streams
    assert route == ("wgmma" if dtype == "bfloat16" and p == 64 else "fma")
    wy, wst = ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    _close(y, wy, TOL[dtype])
    _close(st, wst, TOL["float32"])


# ------------------------------------------------------------- backward

DA_REL = {"float32": 1e-3, "bfloat16": 1e-2}
BWD_CASES = [  # (b, s, h, p, g, n, chunk, dtype, layout, d(final state))
    # mamba2-780m's head dim and state over two chunks of 128 rows (two
    # 64-row tiles each: the tile pairs below and on the diagonal)
    (1, 256, 2, 64, 1, 128, 128, "bfloat16", "projection", False),
    (1, 256, 2, 64, 1, 128, 128, "float32", "contiguous", True),
    # hymba-1.5b's state 16 on the projection views, three heads in a group
    (1, 192, 3, 64, 1, 16, 64, "bfloat16", "projection", False),
    # two groups of two heads (dB and dC summed per group), ragged 64-row
    # tiles (chunk 100), odd p and n
    (2, 200, 4, 24, 2, 40, 100, "float32", "contiguous", True),
    # SMOKE's widths and chunk (p 16, n 16 / 8, chunk 16), one chunk of 1
    (2, 64, 4, 16, 1, 16, 16, "bfloat16", "contiguous", False),
    (1, 48, 4, 16, 2, 8, 16, "float32", "contiguous", True),
    (1, 3, 2, 16, 1, 16, 1, "float32", "contiguous", False),
]


def _bwd_inputs(b, s, h, p, g, n, dtype, layout, seed=0):
    rng = np.random.default_rng(seed)
    normal = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    cdt = getattr(torch, dtype)
    if layout == "projection":
        xbc = normal(b, s, h * p + 2 * g * n).to(cdt)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        x, B, C = normal(b, s, h, p).to(cdt), normal(b, s, g, n).to(cdt), normal(b, s, g, n).to(cdt)
    dt = F.softplus(normal(b, s, h))
    A = -normal(h).exp()
    dy = normal(b, s, h, p).to(cdt)
    return x, dt, A, B, C, dy, normal(b, h, p, n)


def hold_grads(got, want, dtype):
    """Each gradient |d| <= tol·(1+|ref|) of ``ssd_bwd_ref``'s, typed as its
    input; dA (index 2), a sum over every (batch, step) whose terms cancel,
    by its relative error norm instead."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        if name != "dA":
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=TOL[dtype],
                                       atol=TOL[dtype], err_msg=name)
    rel = float((got[2] - want[2]).norm() / want[2].norm())
    assert rel <= DA_REL[dtype], rel


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,layout,dfinal", BWD_CASES)
def test_emulated_backward_matches_autograd(bwd_entry, b, s, h, p, g, n, chunk, dtype, layout,
                                            dfinal):
    x, dt, A, B, C, dy, dstate = _bwd_inputs(b, s, h, p, g, n, dtype, layout)
    dstate = dstate if dfinal else None
    got = ssd.launch_bwd(bwd_entry, x, dt, A, B, C, dy, dstate, chunk, None)
    hold_grads(got, ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk), dtype)


def test_emulated_backward_zeroes_the_padded_tail(bwd_entry):
    """``ssm_forward`` pads the sequence to a chunk multiple with dt = 0 (and
    x, B, C = 0): dx there comes out 0 and every gradient finite."""
    b, s, h, p, g, n, chunk, pad = 1, 128, 2, 64, 1, 16, 64, 40
    x, dt, A, B, C, dy, _ = _bwd_inputs(b, s, h, p, g, n, "bfloat16", "contiguous", seed=1)
    for t in (x, dt, B, C):
        t[:, s - pad:] = 0
    got = ssd.launch_bwd(bwd_entry, x, dt, A, B, C, dy, None, chunk, None)
    assert bool((got[0][:, s - pad:] == 0).all())
    hold_grads(got, ref.ssd_bwd_ref(x, dt, A, B, C, dy, chunk=chunk), "bfloat16")


def test_function_wiring_with_emulated_kernels(entry, bwd_entry, monkeypatch):
    """``ssd``'s autograd ``Function`` with the emulated entries behind the
    wrappers, on CPU tensors: the forward's y and an unused final state
    (its gradient None), x, B and C the views of one projection row, held
    against autograd through ``ssd_ref``; the backward called once."""
    monkeypatch.setattr(ssd, "ssd_cuda", lambda x, dt, A, B, C, chunk: ssd.launch(
        entry, x, dt, A, B, C, chunk, None)[1:])

    calls = []

    def bwd(*args, chunk):
        calls.append(args[-1])   # the final state's gradient: None, the state unused
        return ssd.launch_bwd(bwd_entry, *args, chunk, None)

    monkeypatch.setattr(ssd, "ssd_bwd_cuda", bwd)
    b, s, h, p, g, n, chunk = 1, 128, 2, 64, 1, 16, 64
    x, dt, A, B, C, dy, _ = _bwd_inputs(b, s, h, p, g, n, "bfloat16", "projection", seed=2)
    width = h * p + 2 * g * n
    row = torch.cat([x.flatten(2), B.flatten(2), C.flatten(2)], -1).detach().requires_grad_()
    assert row.shape[-1] == width
    views = (row[..., :h * p].unflatten(2, (h, p)), row[..., h * p:h * p + g * n].unflatten(2, (g, n)),
             row[..., h * p + g * n:].unflatten(2, (g, n)))
    dt, A = dt.requires_grad_(), A.requires_grad_()
    y, _ = ssd.ssd(views[0], dt, A, views[1], views[2], chunk=chunk)
    got = torch.autograd.grad(y, (row, dt, A), dy)
    assert calls == [None]
    # the plain version with the gradient in float32 (``ssd_bwd_ref``'s rule)
    prow = row.detach().float().requires_grad_()
    pdt, pA = dt.detach().clone().requires_grad_(), A.detach().clone().requires_grad_()
    wy, _ = ref.ssd_ref(prow[..., :h * p].unflatten(2, (h, p)), pdt, pA,
                        prow[..., h * p:h * p + g * n].unflatten(2, (g, n)),
                        prow[..., h * p + g * n:].unflatten(2, (g, n)), chunk=chunk)
    want = torch.autograd.grad(wy, (prow, pdt, pA), dy.float())
    _close(y, wy, TOL["bfloat16"])
    assert got[0].dtype == torch.bfloat16
    for g_, w in zip(got, want):
        _close(g_, w, TOL["bfloat16"])


# the backward's wgmma route (bf16, p 64, n a multiple of 16, chunk a
# multiple of 64): n 128, 48 and 16; g 1 and 2; chunks of 64, 128 and 256;
# the projection views; d(final state); fast decay; more heads than a tile
# block walks (6 in one group: slices of 4 and 2).  (b, s, h, p, g, n,
# chunk, layout, d(final state), A scale)
WGMMA_BWD_CASES = [
    (1, 128, 2, 64, 1, 128, 64, "contiguous", True, 1.0),
    (1, 256, 4, 64, 2, 48, 128, "contiguous", True, 1.0),
    (1, 256, 6, 64, 1, 16, 256, "projection", False, 1.0),
    (1, 256, 2, 64, 1, 128, 128, "projection", True, 8.0),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,layout,dfinal,scale", WGMMA_BWD_CASES)
def test_emulated_wgmma_backward_matches_autograd(bwd_entry, b, s, h, p, g, n, chunk, layout,
                                                  dfinal, scale):
    x, dt, A, B, C, dy, dstate = _bwd_inputs(b, s, h, p, g, n, "bfloat16", layout, seed=4)
    A = A * scale
    dstate = dstate if dfinal else None
    assert ssd.ssd_bwd_route(x, B, C, dy, chunk) == "wgmma"
    got = ssd.launch_bwd(bwd_entry, x, dt, A, B, C, dy, dstate, chunk, None)
    hold_grads(got, ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk), "bfloat16")


def test_emulated_fma_backward_takes_the_wgmma_shapes(bwd_entry):
    """The fma route, asked for by name, on the inputs the wgmma route takes
    (the old kernel stays right there: ``bench_ssd --bwd`` times it so)."""
    x, dt, A, B, C, dy, dstate = _bwd_inputs(1, 128, 2, 64, 1, 48, "bfloat16", "projection",
                                             seed=5)
    assert ssd.ssd_bwd_route(x, B, C, dy, 64) == "wgmma"
    got = ssd.launch_bwd(bwd_entry, x, dt, A, B, C, dy, dstate, 64, None, "fma")
    hold_grads(got, ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=64), "bfloat16")


def _one_term(text):
    """The emulated source with every fp32 operand fed as its hi term alone
    (lo = 0): the wgmma route without its precision plan."""
    one = ("namespace hopper { inline void split1(float a, float b, uint32_t& hi, uint32_t& lo) "
           "{ split2(a, b, hi, lo); lo = 0; } }\n")
    text = text.replace("split2(", "split1(")
    head = text.index("namespace {")
    return text[:head] + one + text[head:]


def test_wgmma_bwd_precision_plan_holds_the_tolerances(bwd_entry, tmp_path_factory):
    """Two bf16 terms per fp32 operand (the chunk states' weighted rows, S0
    and dS1 through the carry, G L and L M) keep the wgmma route within
    ``hold_grads``' tolerances at the serving chunk; the same kernel with
    one term each misses them several times over."""
    one = ssd.load_bwd(emulate.build(ssd.BWD_SRC, tmp_path_factory.mktemp("shim_one"), _one_term))
    b, s, h, p, g, n, chunk = 1, 256, 1, 64, 1, 128, 256
    x, dt, A, B, C, dy, dstate = _bwd_inputs(b, s, h, p, g, n, "bfloat16", "contiguous", seed=3)
    want = ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk)
    errs = {}
    for name, entry in (("two terms", bwd_entry), ("one term", one)):
        got = ssd.launch_bwd(entry, x, dt, A, B, C, dy, dstate, chunk, None)
        errs[name] = {k: float(((a.float() - w.float()).abs() / (1 + w.float().abs())).max())
                      for k, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want) if k != "dA"}
        if name == "two terms":
            hold_grads(got, want, "bfloat16")
    print(f"max |d|/(1+|ref|): {errs}")
    assert max(errs["one term"].values()) > 2 * TOL["bfloat16"]
