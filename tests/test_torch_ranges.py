"""The port's profiler ranges (``repro_torch/runtime/ranges.py``) on the
CPU at SMOKE size, under ``torch.profiler`` with the CPU activity only:
the train loop's ranges once a step, the step's phases inside
``train.step``, a prefill's and each decode step's range, the MoE and
encoder-decoder ranges under their names, and nothing entered with the
profiler off.  On the card (``-k card``) the kernels' ranges, and the
kernels' device time that ``launch/profile_train.py`` and
``launch/profile_serve.py`` read through them against the time of the
kernels by name."""
import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_smoke
from repro_torch.core import NVCache, Policy
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import serve
from repro_torch.models.registry import build
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import ranges
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import DRAM, Tier
from repro_torch.train import loop as train_loop
from repro_torch.train import steps as train_steps

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
POL = dict(entry_size=16384, log_entries=8192, page_size=4096,
           read_cache_pages=64, batch_min=8, batch_max=512, verify_crc=False)
STEPS = 3
PHASES = train_steps.PHASES
# the CUDA kernels of each hand-written kernel (substrings of their names):
# the forward's routes, the backward's delta, dq, dkdv and wgmma kernels;
# K3's chunk states, carry and outputs, and its backward's two routes
# (wgmma: state, split carry, tiles, dc; fma: states, carry, chunk) with
# their bf16 casts
KERNEL_NAMES = {
    "k1": ("fa_fwd_",), "k1b": ("bwd_delta", "bwd_dq_", "bwd_dkdv_", "bwd_wgmma"),
    "k2": ("quantize_kernel",),
    "k3": ("ssd_chunk_state", "ssd_carry", "ssd_chunk_out", "ssd_fwd"),
    "k3b": ("ssd_bwd_state", "ssd_bwd_split_carry", "ssd_bwd_tiles", "ssd_bwd_dc",
            "ssd_bwd_carry", "ssd_bwd_chunk", "cast_rows")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the other SMOKE model tests pin: the suite's
    parallel workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof, prefix=""):
    """{name: sorted [(start, end)]} of the profile's ``record_function``
    ranges whose name starts with ``prefix``, on the host (with the CUDA
    activity each also has a row on the device's timeline)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(prefix)):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _train(compress=False, steps=STEPS, ckpt_every=2):
    cfg = get_smoke("llama3.2-1b")
    nv = NVCache(Policy(**POL), Tier(DRAM))
    try:
        train_loop.train(build(cfg), AdamW(lr=1e-3),
                         SyntheticTokens(cfg.vocab, batch=2, seq=32, seed=9), NVCacheFS(nv),
                         total_steps=steps, ckpt_every=ckpt_every, device="cpu",
                         compress_grads=compress)
    finally:
        nv.shutdown()


def _serve(arch, n_tokens, batch=2, prompt_len=20):
    cfg = get_smoke(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(1, cfg.vocab - 1, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    with torch.inference_mode():
        logits, cache = serve.prefill(model, params, prompts, n_tokens)
        serve.decode(model, params, logits, cache, n_tokens)


def test_train_loop_ranges_once_a_step_in_order():
    """One ``train.batch``, ``train.step`` and ``train.log`` a step, in that
    order; the checkpoints (after steps 2 and 3) open no range of their
    own, and the step's phases are all the other ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train()
    got = _ranges(prof, "train.")
    for name in ("train.batch", "train.step", "train.log"):
        assert len(got[name]) == STEPS, name
    assert set(got) == {"train.batch", "train.step", "train.log", *PHASES} - {"train.compress"}
    for i in range(STEPS):
        b, s, log = (got[n][i] for n in ("train.batch", "train.step", "train.log"))
        assert b[1] <= s[0] and s[1] <= log[0]


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
def test_step_phases_nest_inside_train_step(compress):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(compress=compress)
    got = _ranges(prof, "train.")
    steps = got["train.step"]
    for name in PHASES:
        want = 0 if name == "train.compress" and not compress else STEPS
        assert len(got.get(name, [])) == want, name
        for s, e in got.get(name, []):
            assert any(s0 <= s and e <= e1 for s0, e1 in steps), name


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
@pytest.mark.parametrize("n_tokens", [1, 3])
def test_prefill_once_and_a_range_per_decode_step(arch, n_tokens):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(arch, n_tokens)
    got = _ranges(prof, "serve.")
    assert len(got["serve.prefill"]) == 1
    assert len(got["serve.decode_step"]) == n_tokens
    assert got["serve.prefill"][0][1] <= got["serve.decode_step"][0][0]


@pytest.mark.parametrize("arch, names", [
    ("qwen3-moe-30b-a3b", ("moe.dispatch", "moe.experts", "moe.combine")),
    ("whisper-small", ("encdec.cross_attention",)),
])
def test_moe_and_encdec_ranges_keep_their_names(arch, names):
    """The ranges ``launch/profile_serve.py`` reads, a layer each a prefill
    (whisper-small's prompt is its frames, as the serving launcher's)."""
    cfg = get_smoke(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(arch, 1)
    got = _ranges(prof)
    layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    for name in names:
        assert len(got.get(name, [])) >= layers, name


def test_profiler_off_enters_no_range(monkeypatch):
    """With no profiler running ``span`` hands out the one shared null
    context, and a train step and a served batch enter no
    ``record_function``; with one running they do (the count sees them)."""
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)
    assert ranges.span("train.step") is ranges.span("k3.fwd")
    assert isinstance(ranges.span("train.step"), contextlib.nullcontext)
    _train(compress=True, steps=1, ckpt_every=1)
    _serve("mamba2-780m", 2)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(ranges.span("train.step"), contextlib.nullcontext)
        _serve("mamba2-780m", 2)
    assert entered.count("serve.decode_step") == 2


def _span_names(path):
    """The literal names of ``span(...)`` calls in ``path``, with
    ``CROSS_SPAN`` read as its value."""
    tree = ast.parse(path.read_text())
    consts = {t.id: n.value.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant)}
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "span" and n.args:
            a = n.args[0]
            out.append(a.value if isinstance(a, ast.Constant) else consts[a.id])
    return out


def test_every_range_the_port_opens_is_named():
    """Every ``span`` call in the port names one of ``NAMES``, once each:
    the kernel wrappers' too, which run only on the card."""
    used = [n for p in sorted(PORT.rglob("*.py")) for n in _span_names(p)]
    assert sorted(used) == sorted(ranges.NAMES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def test_kernel_ranges_on_the_card(cuda):
    """K1, K1's backward, K2, K3 and K3's backward each open their range
    once a call, and the profiler's CUDA calls inside it launch their
    kernels."""
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g, device=dev, dtype=torch.bfloat16)
               .requires_grad_() for _ in range(3))
    x = torch.randn(1, 128, 2, 64, generator=g, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    dt = torch.rand(1, 128, 2, generator=g, device=dev).requires_grad_()
    A = -torch.rand(2, generator=g, device=dev).requires_grad_()
    B, C = (torch.randn(1, 128, 1, 16, generator=g, device=dev, dtype=torch.bfloat16)
            .requires_grad_() for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        o = ops.flash_attention(q, k, v, causal=True)
        y, _ = ops.ssd(x, dt, A, B, C, chunk=64)
        (o.float().sum() + y.float().sum()).backward()
        ops.quantize(torch.randn(4, 256, device=dev))
        torch.cuda.synchronize()
    got = _ranges(prof)
    launches = [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith("cu") and "Launch" in e.name()]
    for name in ("k1.fwd", "k1.bwd", "k2.quantize", "k3.fwd", "k3.bwd"):
        assert len(got.get(name, [])) == 1, name
        s, e = got[name][0]
        assert any(s <= t <= e for t in launches), name
    assert np.isfinite(o.float().sum().item())


def _named_ms(prof, names):
    """Device time (ms) of the profile's CUDA kernels whose name holds one
    of ``names``."""
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CPU
               and not e.is_user_annotation() and any(n in e.name() for n in names)) / 1e6


@pytest.mark.parametrize("tool", ["train", "serve"])
def test_profiles_read_each_kernel_range_as_its_kernels_on_the_card(cuda, monkeypatch, tool):
    """The kernels' device time that ``profile_train`` and ``profile_serve``
    print, read through each kernel's range, is that of the kernel's own
    CUDA kernels by name in the same profile, within 1%: no other device
    work runs inside a range.  hymba-1.5b runs all five kernels in training
    and K1 and K3 in its prefill.  ``profile_train``'s step phases hold
    device time each and together no more than the step's."""
    from repro_torch.launch import profile_serve, profile_train
    made = []

    def kept(*args, **kwargs):
        made.append(profile(*args, **kwargs))
        return made[-1]

    arch = "hymba-1.5b"
    if tool == "train":
        monkeypatch.setattr(profile_train, "profile", kept)
        result = profile_train.main(["--arch", arch])
        got, want = result["kernel_ms_per_step"], dict(KERNEL_NAMES)
        assert all(ms > 0 for ms in result["phase_ms_per_step"].values())
        assert sum(result["phase_ms_per_step"].values()) <= result["device_ms"] * (1 + 1e-6)
    else:
        monkeypatch.setattr(profile_serve, "profile", kept)
        result = profile_serve.profile_arch(arch, "", profile_serve.one_card_config(arch))
        got = {k: result[f"{k}_ms_per_prefill"] for k in profile_serve.KERNELS}
        want = {k: KERNEL_NAMES[k] for k in profile_serve.KERNELS}
    for k, names in want.items():
        by_name = _named_ms(made[0], names)
        print(f"{tool} {k}: range {got[k]:.6f} ms, by name {by_name:.6f} ms, "
              f"{got[k] / by_name - 1:+.3e}")
        assert by_name > 0 and got[k] == pytest.approx(by_name, rel=0.01), k
