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
prefill and, summed over the CUDA kernels each of them runs (``OWN``),
their device time per prefill and share of the prefill's device time;
for an MoE model the device time per prefill and per decode step of its
expert products, dispatch and combine (the ``moe.*`` spans of
``models/moe.py``) and the (token, k) pairs a prefill drops over
capacity; for the encoder-decoder K1's device time per prefill by kind of
call (encoder, decoder self-attention, cross-attention: its launches in
the order the prefill makes them) and the cross-attention's device time
per prefill and per decode step with its share of each (the
``encdec.cross_attention`` span of ``models/encdec.py``; a span's device
time counts the kernels of torch ops only, not those launched through
``ctypes``, so the prefill's cross-attention is the span's plus K1's
cross calls); then one JSON line with those numbers and the card's name and
power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import all_archs, get_config
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda
from repro_torch.launch.serve import decode, prefill
from repro_torch.models import encdec, moe
from repro_torch.models.registry import build

B, P, T, SEED = 4, 2048, 32, 0   # the slices' serving shape
PROMPT = {"whisper-small": encdec.ENC_LEN}   # an arch's own prompt length (frames)
KERNELS = {"k1": flash_attention_cuda, "k3": ssd_cuda}
# device-kernel names of the hand-written kernels (substrings of the profiler's keys)
OWN = {"k1": ("fa_fwd_",), "k3": ("ssd_fwd", "ssd_chunk_state", "ssd_carry", "ssd_chunk_out")}
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
MOE_SPANS = ("moe.experts", "moe.dispatch", "moe.combine")   # models/moe.py's record_function
SPANS = (*MOE_SPANS, encdec.CROSS_SPAN)


def one_card_config(arch: str):
    """``arch``'s config as it serves on one 80 GB card; raises ValueError
    for an arch in ``WAITING``."""
    if arch in WAITING:
        raise ValueError(f"{arch} does not serve on one card at full width: {WAITING[arch]}")
    return dataclasses.replace(get_config(arch), **ONE_CARD.get(arch, {}))


def _span_ms(prof, name):
    """Device time (ms) of the kernels launched inside ``record_function(name)``:
    the device time of its host-side row's children (its device-side row
    spans the GPU timeline, idle gaps included)."""
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3


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
    ``record_function`` spans, which time a stretch of the GPU's timeline."""
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in SPANS]
    return sorted(rows, key=lambda r: -r[1])


def _k1_by_kind(prof, cfg):
    """An encoder-decoder prefill's K1 device time (ms) by kind of call,
    from its K1 kernels in launch order: the encoder's layers, then each
    decoder layer's self-attention and cross-attention.  None when the
    profile holds another number of K1 kernels."""
    calls = sorted((e for e in prof.events()
                    if e.device_type != torch.autograd.DeviceType.CPU
                    and any(n in e.name for n in OWN["k1"])),
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
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_p:
            logits, cache = prefill(model, params, prompts, T)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
            decode(model, params, logits, cache, T)
            torch.cuda.synchronize()
        for k, fn in KERNELS.items():
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
            if by_kind:
                ms = _span_ms(prof, encdec.CROSS_SPAN) + by_kind["cross"]
                result["cross_attention_ms_per_prefill"] = ms
                result["cross_attention_share_of_prefill"] = ms / dev_ms
                print(f"  cross-attention with its K1 calls: {ms:.3f} ms per prefill, "
                      f"{ms / dev_ms:.1%}")
        if name == "prefill":
            for k, names in OWN.items():
                ms = sum(v for key, v in rows if any(n in key for n in names))
                result[f"{k}_ms_per_prefill"] = ms
                result[f"{k}_share_of_prefill"] = ms / dev_ms
                if ms:
                    print(f"  {k}: {ms:.3f} ms per prefill over its CUDA kernels, "
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
