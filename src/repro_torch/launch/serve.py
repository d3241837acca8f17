"""Serving launcher: batched prefill + greedy decode with NVCache-backed
request logging (every accepted request is synchronously durable before
decode — no request is lost to a crash).

    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke --tokens 16

``--arch`` is one of the architectures: llama3.2-1b, minicpm3-4b,
granite-20b, minitron-8b, whisper-small, arctic-480b, qwen3-moe-30b-a3b,
hymba-1.5b, qwen2-vl-7b or mamba2-780m.  The encoder-decoder whisper-small
encodes ``--prompt-len`` zero frames (the audio front end is a stub, as in
the JAX launcher) and decodes from the first 8 prompt tokens:

    python -m repro_torch.launch.serve --arch whisper-small --prompt-len 1500 --tokens 32

Runs on the CUDA device unless ``--device cpu`` is given.  ``main``'s
``cfg`` keyword serves a config of the caller's in place of ``--arch``'s,
e.g. granite-20b or qwen3-moe-30b-a3b with
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
from repro_torch.launch import decode_graph
from repro_torch.models.registry import Model, build
from repro_torch.runtime.ranges import span
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


DEC_PROMPT = 8   # an encoder-decoder's decoder prompt: the first 8 prompt tokens


def prefill_batch(cfg, prompts):
    """The prefill batch of ``prompts`` (B, P), as ``repro.launch.serve``
    builds it: the tokens, or for the encoder-decoder P zero frames in the
    compute dtype and the first ``DEC_PROMPT`` tokens as the decoder's."""
    if cfg.family == "encdec":
        B, P = prompts.shape
        return {"frames": torch.zeros((B, P, cfg.d_model), dtype=cfg.cdt, device=prompts.device),
                "dec_tokens": prompts[:, :DEC_PROMPT]}
    return {"tokens": prompts}


def prefill(model: Model, params, prompts, n_tokens: int):
    """Batched prefill with room for ``n_tokens`` more (the cache has
    P + ``n_tokens`` + 8 rows, as the JAX launcher sizes it).  Returns
    (logits, cache), under the range ``serve.prefill``."""
    with span("serve.prefill"):
        return model.prefill(params, prefill_batch(model.cfg, prompts),
                             prompts.shape[1] + n_tokens + 8)


def decode(model: Model, params, logits, cache, n_tokens: int):
    """Greedy decode of ``n_tokens`` tokens.  Returns (tokens (B, n_tokens),
    last logits); the cache's tensors are updated in place and its ``pos``
    rebound.  Each step is one ``serve.decode_step`` range.  Where
    ``decode_graph.replay_for`` gives a replay (a CUDA device, inference
    mode, plain tensors, a family whose decode step runs no host code of
    its own), each step is the replay of one CUDA graph; otherwise it runs
    op by op."""
    replay = decode_graph.replay_for(model, params, logits, cache, n_tokens)
    out = []
    for i in range(n_tokens):
        with span("serve.decode_step"):
            if replay is not None:
                replay.step(i)
                continue
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
    if replay is not None:
        return replay.finish()
    decode_graph.COUNTS.eager_steps += n_tokens
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
