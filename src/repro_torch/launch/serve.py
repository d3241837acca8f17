"""Serving launcher: batched prefill + greedy decode with NVCache-backed
request logging (every accepted request is synchronously durable before
decode — no request is lost to a crash).

    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke --tokens 16

``--arch`` is one of the ported architectures: llama3.2-1b, minicpm3-4b,
granite-20b, minitron-8b, arctic-480b, qwen3-moe-30b-a3b, hymba-1.5b,
qwen2-vl-7b or mamba2-780m.  Runs on the CUDA device unless ``--device
cpu`` is given.  ``main``'s ``cfg`` keyword serves a config of the caller's
in place of ``--arch``'s, e.g. granite-20b or qwen3-moe-30b-a3b with
``param_dtype="bfloat16"`` (their float32 parameters do not fit one 80 GB
card; ``launch.profile_serve.one_card_config`` gives that config):

    main(["--arch", "granite-20b"],
         cfg=dataclasses.replace(get_config("granite-20b"), param_dtype="bfloat16"))
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.core import NVCache, Policy
from repro_torch.models.registry import Model, build
from repro_torch.storage.fsapi import NVCacheFS
from repro_torch.storage.tiers import BLOB, Tier


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, n) generated token ids
    logits: torch.Tensor        # (B, 1, vocab) logits after the last step
    log: bytes                  # the request log, read back through NVCacheFS
    prefill_s: float
    decode_s: float


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(model: Model, params, prompts, n_tokens: int):
    """Batched prefill with room for ``n_tokens`` more.  Returns (logits, cache)."""
    return model.prefill(params, {"tokens": prompts}, prompts.shape[1] + n_tokens + 8)


def decode(model: Model, params, logits, cache, n_tokens: int):
    """Greedy decode of ``n_tokens`` tokens.  Returns (tokens (B, n_tokens),
    last logits)."""
    out = []
    for _ in range(n_tokens):
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    return torch.cat(out, 1), logits


def generate(model: Model, params, prompts, n_tokens: int):
    """Greedy batched prefill + decode of ``n_tokens`` tokens.  Returns
    (tokens (B, n_tokens), last logits, prefill seconds, decode seconds)."""
    t0 = time.perf_counter()
    logits, cache = prefill(model, params, prompts, n_tokens)
    _sync(prompts.device)
    t1 = time.perf_counter()
    tokens, logits = decode(model, params, logits, cache, n_tokens)
    _sync(prompts.device)
    t2 = time.perf_counter()
    return tokens, logits, t1 - t0, t2 - t1


def main(argv=None, cfg=None) -> ServeResult:
    """Serves one batch of random prompts with the durable request log;
    ``cfg``, when given, is served in place of the config ``--arch`` and
    ``--smoke`` name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=all_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = model.init(gen)

    nv = NVCache(Policy(entry_size=4096, log_entries=4096,
                        read_cache_pages=64, batch_min=8, batch_max=256,
                        verify_crc=False), Tier(BLOB))
    try:
        fs = NVCacheFS(nv)
        log_fd = fs.open("/requests.jsonl")
        log_off = 0

        B, P = args.batch, args.prompt_len
        prompts = torch.randint(1, cfg.vocab - 1, (B, P), generator=gen, device=device,
                                dtype=torch.int32)
        # request accepted == durably logged (synchronous durability)
        line = (json.dumps({"batch": B, "prompt_len": P}) + "\n").encode()
        log_off += fs.pwrite(log_fd, line, log_off)

        with torch.inference_mode():
            tokens, logits, prefill_s, decode_s = generate(model, params, prompts, args.tokens)
        dt = prefill_s + decode_s
        line = (json.dumps({"completed": tokens.shape[0] * tokens.shape[1],
                            "seconds": dt}) + "\n").encode()
        log_off += fs.pwrite(log_fd, line, log_off)
        print(json.dumps({"arch": cfg.arch, "batch": B,
                          "tokens_per_s": B * args.tokens / dt,
                          "sample": tokens[0, :8].tolist()}))
        log = fs.pread(log_fd, log_off, 0)
        fs.close(log_fd)
    finally:
        nv.shutdown()
    return ServeResult(tokens=tokens, logits=logits, log=log,
                       prefill_s=prefill_s, decode_s=decode_s)


if __name__ == "__main__":
    main()
