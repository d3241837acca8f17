"""Where the serving time goes on the card, warm.

    python -m repro_torch.launch.profile_serve [ARCH ...]

Serves each ported arch that fits one card in turn (the registry's, in
its order: llama3.2-1b, minicpm3-4b, granite-20b, minitron-8b,
whisper-small, qwen3-moe-30b-a3b, hymba-1.5b, qwen2-vl-7b, mamba2-780m;
not arctic-480b, ``WAITING``), or those named on the command line, at full
width (batch 4, prompt 2048, 32 new tokens, seed 0; whisper-small's
prompt is its encoder's 1500 frames, ``PROMPT``; granite-20b and
qwen3-moe-30b-a3b with bfloat16 parameters, :func:`one_card_config`),
each one's parameters freed before the next is drawn, with
``repro_torch.launch.serve``'s prefill and decode: one run to warm up
(allocator, cuBLAS, kernel library), ``REPS`` timed on the host clock
around synchronised work (their median is reported, with the fastest and
slowest: the host's clock varies between runs), and one under
``torch.profiler`` for the device time by kernel.  For each it prints the
warm prefill time, the decode time per step, the device-busy share of each
(device kernel time over the median timed run's wall time), the kernels
that take the most device time, the hand-written kernels' launches per
prefill and their device time per prefill and share of the prefill's
device time (the device work launched inside their ranges ``k1.fwd`` and
``k3.fwd``, ``runtime/ranges.py``); for an MoE model the device time per
prefill and per decode step of its expert products, dispatch and combine
(the ``moe.*`` ranges of ``models/moe.py``) and the (token, k) pairs a
prefill drops over capacity; for the encoder-decoder K1's device time per
prefill by kind of call (encoder, decoder self-attention,
cross-attention: its launches in the order the prefill makes them) and
the cross-attention's device time per prefill and per decode step with
its share of each (the ``encdec.cross_attention`` range of
``models/encdec.py``, its K1 calls included); then one JSON line with
those numbers and the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import all_archs, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import decode, prefill
from repro_torch.models import encdec, moe
from repro_torch.models.registry import build
from repro_torch.runtime.ranges import NAMES

B, P, T, SEED = 4, 2048, 32, 0   # the slices' serving shape
PROMPT = {"whisper-small": encdec.ENC_LEN}   # an arch's own prompt length (frames)
# each hand-written kernel's wrapper (it counts the launches) and range
KERNELS = {"k1": (fa.flash_attention_cuda, fa.FWD_SPAN), "k3": (ssd.ssd_cuda, ssd.FWD_SPAN)}
K1_NAME = "fa_fwd_"    # K1's CUDA kernels (a substring of their names), in launch order
TOP = 12                         # kernels listed per phase
REPS = 5                         # timed runs of each phase
# what an arch's config must change to serve on one 80 GB card: granite-20b's
# float32 parameters (28.37 B, 105.7 GiB) do not fit, its bfloat16 ones (52.8
# GiB) do; qwen3-moe-30b-a3b's likewise (30.53 B: 113.7 GiB, 56.9 GiB)
ONE_CARD = {"granite-20b": {"param_dtype": "bfloat16"},
            "qwen3-moe-30b-a3b": {"param_dtype": "bfloat16"}}
# archs no one-card config serves at full width
WAITING = {"arctic-480b": "~477 B parameters, ~27 GB of bfloat16 a layer: two of its "
                          "35 layers fill an 80 GB card"}
MOE_SPANS = (moe.EXPERTS_SPAN, moe.DISPATCH_SPAN, moe.COMBINE_SPAN)


def one_card_config(arch: str):
    """``arch``'s config as it serves on one 80 GB card; raises ValueError
    for an arch in ``WAITING``."""
    if arch in WAITING:
        raise ValueError(f"{arch} does not serve on one card at full width: {WAITING[arch]}")
    return dataclasses.replace(get_config(arch), **ONE_CARD.get(arch, {}))


def _span_ms(prof, name):
    """Device time (ms) of the work launched inside the range ``name``:
    every kernel, copy and set whose CUDA API call (a host event named
    ``cu...``, of the same correlation id) starts inside one of the
    range's host intervals.  Kernels launched through ``ctypes`` count as
    those of torch ops do: they are no child of the range in the
    profiler's tree, and the range's device-side row spans the GPU
    timeline, idle gaps included."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                    if e.name() == name and e.device_type() == cpu)
    starts = [s for s, _ in ranges]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    launched = {e.correlation_id() for e in events if e.device_type() == cpu
                and e.name().startswith("cu") and inside(e.start_ns())}
    return sum(e.duration_ns() for e in events if e.device_type() != cpu
               and not e.is_user_annotation() and e.correlation_id() in launched) / 1e6


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_ms(prof):
    """Device time (ms) by kernel name, largest first.  Operator rows (on
    the CPU) are left out: their device time is that of the kernels they
    launched, which are rows of their own; so are the device-side rows of
    the ranges, which time a stretch of the GPU's timeline."""
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in NAMES]
    return sorted(rows, key=lambda r: -r[1])


def _k1_by_kind(prof, cfg):
    """An encoder-decoder prefill's K1 device time (ms) by kind of call,
    from its K1 kernels in launch order: the encoder's layers, then each
    decoder layer's self-attention and cross-attention.  None when the
    profile holds another number of K1 kernels."""
    calls = sorted((e for e in prof.events()
                    if e.device_type != torch.autograd.DeviceType.CPU
                    and K1_NAME in e.name),
                   key=lambda e: e.time_range.start)
    kinds = ["encoder"] * cfg.enc_layers + ["self", "cross"] * cfg.dec_layers
    if len(calls) != len(kinds):
        return None
    out = dict.fromkeys(("encoder", "self", "cross"), 0.0)
    for kind, e in zip(kinds, calls):
        out[kind] += e.time_range.elapsed_us() / 1e3
    return out


def profile_arch(arch: str, card: str, cfg=None):
    """Warm prefill and decode of ``arch`` (``cfg`` in place of its config
    when given) at the serving shape; prints the breakdown and returns it
    as a dict."""
    dev = torch.device("cuda")
    cfg = get_config(arch) if cfg is None else cfg
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(dev).manual_seed(SEED)
    prompt_len = PROMPT.get(arch, P)
    result = {"arch": cfg.arch, "batch": B, "prompt_len": prompt_len, "tokens": T}
    with torch.inference_mode():
        params = model.init(gen)
        prompts = torch.randint(1, cfg.vocab - 1, (B, prompt_len), generator=gen, device=dev,
                                dtype=torch.int32)
        logits, cache = prefill(model, params, prompts, T)            # warm-up
        decode(model, params, logits, cache, T)
        runs = {"prefill": [], "decode": []}
        for _ in range(REPS):
            (logits, cache), wall_s = _timed(lambda: prefill(model, params, prompts, T))
            runs["prefill"].append(wall_s)
            runs["decode"].append(_timed(lambda: decode(model, params, logits, cache, T))[1])
        prefill_s, decode_s = (statistics.median(runs[name]) for name in ("prefill", "decode"))
        launches = {k: fn.launches for k, (fn, _) in KERNELS.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_p:
            logits, cache = prefill(model, params, prompts, T)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
            decode(model, params, logits, cache, T)
            torch.cuda.synchronize()
        for k, (fn, _) in KERNELS.items():
            result[f"{k}_launches_per_prefill"] = fn.launches - launches[k]
        if cfg.family == "moe":
            with moe.count_drops() as drops:
                prefill(model, params, prompts, T)
            result["moe_dropped_pairs_per_prefill"] = int(sum(drops))
            result["moe_pairs_per_prefill"] = B * prompt_len * cfg.top_k * cfg.n_layers

    for name, prof, wall_s, steps in (("prefill", prof_p, prefill_s, 1),
                                      ("decode", prof_d, decode_s, T)):
        rows = _device_ms(prof)
        dev_ms = sum(ms for _, ms in rows)
        result[f"{name}_ms"] = wall_s * 1e3 / steps
        result[f"{name}_ms_runs"] = [t * 1e3 / steps for t in runs[name]]
        result[f"{name}_device_ms"] = dev_ms / steps
        result[f"{name}_device_busy"] = dev_ms / (wall_s * 1e3)
        print(f"{arch} {name}: {wall_s * 1e3 / steps:.3f} ms{' per step' if steps > 1 else ''} "
              f"warm (median of {REPS}, {min(runs[name]) * 1e3 / steps:.3f}-"
              f"{max(runs[name]) * 1e3 / steps:.3f}), device kernels {dev_ms / steps:.3f} ms, "
              f"busy {dev_ms / (wall_s * 1e3):.1%} of the median unprofiled wall time")
        for key, ms in rows[:TOP]:
            print(f"  {ms / steps:9.3f} ms  {ms / dev_ms:6.1%}  {key[:100]}")
        result[f"{name}_top"] = [[key[:100], ms / steps] for key, ms in rows[:TOP]]
        spans = {"moe": MOE_SPANS, "encdec": (encdec.CROSS_SPAN,)}.get(cfg.family, ())
        for span in spans:
            ms = _span_ms(prof, span) / steps
            result[f"{span.replace('.', '_')}_ms_per_{name}"] = ms
            result[f"{span.replace('.', '_')}_share_of_{name}"] = ms * steps / dev_ms
            print(f"  {span}: {ms:.3f} ms{' per step' if steps > 1 else ''} of device "
                  f"time, {ms * steps / dev_ms:.1%}")
        if name == "prefill" and cfg.family == "encdec":
            by_kind = _k1_by_kind(prof, cfg)
            result["k1_ms_per_prefill_by_kind"] = by_kind
            print(f"  k1 by kind of call (ms per prefill): {by_kind}")
        if name == "prefill":
            for k, (_, rng) in KERNELS.items():
                ms = _span_ms(prof, rng)
                result[f"{k}_ms_per_prefill"] = ms
                result[f"{k}_share_of_prefill"] = ms / dev_ms
                if ms:
                    print(f"  {k}: {ms:.3f} ms per prefill inside its range {rng}, "
                          f"{ms / dev_ms:.1%} of the prefill's device time")
    result["decode_tokens_per_s"] = B * T / decode_s
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["card"] = card
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device")
    archs = (sys.argv[1:] if argv is None else argv) or [a for a in all_archs()
                                                         if a not in WAITING]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    results = []
    for arch in archs:
        results.append(profile_arch(arch, smi.stdout.strip(), one_card_config(arch)))
        torch.cuda.empty_cache()   # the next arch's parameters need the room
    return results


if __name__ == "__main__":
    main()
