"""Greedy decode replayed as CUDA graphs (``launch/decode_graph.py``):
``serve.decode`` against the eager loop it replays (argmax, then
``decode_step``, a token at a time) on a copy of the same cache.  Tokens,
last logits and the cache after decode are equal bitwise.  On the CPU every
arch's SMOKE config runs eagerly.  On the card (``-k card``; those tests
skip without one) every SMOKE config outside ``EAGER_FAMILIES`` replays a
graph, as do mamba2-780m and hymba-1.5b at full width (batch 16, prompts of
1,024 and 1,280 tokens, 16 new tokens); the graphs are captured once per
cache shape, none after the serving cells' set-up, what stays resident
between requests is bounded by the largest shape, and it goes with the
parameters.  Imports no JAX, so it runs where only the port is installed."""
import dataclasses
import gc

import pytest
import torch

from repro_torch.configs.registry import all_archs, get_config, get_smoke
from repro_torch.launch import decode_graph, serve
from repro_torch.models.registry import build


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: SMOKE-size ops gain nothing from more, and the
    suite's parallel workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")


def _counts():
    return dataclasses.asdict(decode_graph.COUNTS)


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()}


def eager_decode(model, params, logits, cache, n_tokens):
    """The eager loop on a copy of ``cache``: (tokens, last logits, cache)."""
    cache = {k: v.clone() for k, v in cache.items()}
    out = []
    for _ in range(n_tokens):
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
    return torch.cat(out, 1), logits, cache


def _check_batch(model, params, prompts, n_tokens):
    """One prefill, then eager decode on a copy of its cache and
    ``serve.decode`` on it; asserts them equal bitwise."""
    logits, cache = serve.prefill(model, params, prompts, n_tokens)
    pos = cache["pos"]
    p0 = int(pos)
    want, want_logits, want_cache = eager_decode(model, params, logits, cache, n_tokens)
    got, got_logits = serve.decode(model, params, logits, cache, n_tokens)
    assert torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)
    assert cache.keys() == want_cache.keys()
    for k, v in want_cache.items():
        assert torch.equal(cache[k], v), k
    assert int(pos) == p0        # rebound, as decode_step rebinds it
    assert int(cache["pos"]) == p0 + n_tokens


@pytest.mark.parametrize("arch, shapes, again", [("mamba2-780m", 1, 0), ("hymba-1.5b", 2, 1)])
def test_full_width_graph_decode_equals_eager_on_the_card(cuda, arch, shapes, again):
    """Prompts of 1,024 then 1,280 tokens: mamba2's cache has no sequence
    axis, one graph for both; hymba's k/v caches are sized by the prompt,
    one graph each, and the longer prompt grows the shared buffers, so the
    first graph is captured again over them.  A second batch of 1,280
    tokens captures nothing and replays 16 times."""
    cfg = get_config(arch)
    model = build(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    B, n = 16, 16
    with torch.inference_mode():
        params = model.init(gen)
        before = _counts()
        for P in (1024, 1280):
            prompts = torch.randint(1, cfg.vocab - 1, (B, P), generator=gen, device="cuda",
                                    dtype=torch.int32)
            _check_batch(model, params, prompts, n)
        assert _moved(before) == {"captures": shapes, "recaptures": again, "replays": 2 * n,
                                  "eager_steps": 0}
        before = _counts()
        _check_batch(model, params, prompts.flip(0), n)
        assert _moved(before) == {"captures": 0, "recaptures": 0, "replays": n,
                                  "eager_steps": 0}


@pytest.mark.parametrize("arch", all_archs())
@pytest.mark.parametrize("where", ["cpu", "card"])
def test_smoke_decode_equals_the_eager_loop(where, arch):
    """Every arch at SMOKE size: on the CPU each step runs op by op; on the
    card a family outside ``EAGER_FAMILIES`` replays one graph."""
    if where == "card" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    device = "cuda" if where == "card" else "cpu"
    cfg = get_smoke(arch)
    model = build(cfg)
    gen = torch.Generator(device).manual_seed(0)
    n = 10
    with torch.inference_mode():
        params = model.init(gen)
        prompts = torch.randint(1, cfg.vocab - 1, (3, 20), generator=gen, device=device,
                                dtype=torch.int32)
        before = _counts()
        _check_batch(model, params, prompts, n)
    graphed = where == "card" and cfg.family not in decode_graph.EAGER_FAMILIES
    assert _moved(before) == ({"captures": 1, "recaptures": 0, "replays": n, "eager_steps": 0}
                              if graphed else
                              {"captures": 0, "recaptures": 0, "replays": 0, "eager_steps": n})


# the serving cells' prompt lengths (bench/traffic/serve_longdoc.json: 1,024 to
# 8,192 in 8 steps) over 128
LENGTHS = (8, 10, 14, 20, 26, 36, 48, 64)


@pytest.mark.parametrize("arch, shapes, again", [("mamba2-780m", 1, 0), ("hymba-1.5b", 8, 28)])
def test_nothing_is_captured_after_the_serving_setup_on_the_card(cuda, arch, shapes, again):
    """The serving cells' set-up decodes one batch of each length, shortest
    first; then a cycle of the lengths in another order replays only.  Each
    longer prompt grows hymba's buffers and captures the graphs before it
    again (1 + 2 + ... + 7 = 28), all in set-up.  SMOKE size, every batch
    equal bitwise to the eager loop."""
    cfg = get_smoke(arch)
    model = build(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    B, n = 3, 4

    def batch(P):
        prompts = torch.randint(1, cfg.vocab - 1, (B, P), generator=gen, device="cuda",
                                dtype=torch.int32)
        _check_batch(model, params, prompts, n)

    with torch.inference_mode():
        params = model.init(gen)
        before = _counts()
        for P in sorted(LENGTHS):
            batch(P)
        assert _moved(before) == {"captures": shapes, "recaptures": again,
                                  "replays": len(LENGTHS) * n, "eager_steps": 0}
        before = _counts()
        for P in (36, 8, 64, 20, 48, 10, 26, 14):
            batch(P)
        assert _moved(before) == {"captures": 0, "recaptures": 0,
                                  "replays": len(LENGTHS) * n, "eager_steps": 0}


def test_resident_memory_is_bounded_by_the_largest_shape_on_the_card(cuda):
    """hymba-1.5b at full width, batch 2, 4 new tokens, prompts of
    ``MAX_GRAPHS`` + 4 distinct lengths, longest first: each length is
    captured once, at most ``MAX_GRAPHS`` graphs stay, and the memory held
    between requests stays where the first left it, within 16 MiB (a
    static k/v cache a length would add 40 KB a row and sequence, ~120 MB a
    length here)."""
    cfg = get_config("hymba-1.5b")
    model = build(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    lengths = [1600 - 32 * i for i in range(decode_graph.MAX_GRAPHS + 4)]
    held = []
    with torch.inference_mode():
        params = model.init(gen)
        before = _counts()
        for P in lengths:
            prompts = torch.randint(1, cfg.vocab - 1, (2, P), generator=gen, device="cuda",
                                    dtype=torch.int32)
            logits, cache = serve.prefill(model, params, prompts, 4)
            tokens, logits = serve.decode(model, params, logits, cache, 4)
            del prompts, logits, cache, tokens
            held.append(torch.cuda.memory_allocated())
            if len(held) == 1:
                free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
            assert max(len(g.graphs) for g in decode_graph._TREES.values()) <= \
                decode_graph.MAX_GRAPHS
        assert _moved(before) == {"captures": len(lengths), "recaptures": 0,
                                  "replays": 4 * len(lengths), "eager_steps": 0}
    outside = free0 - torch.cuda.mem_get_info()[0] - (torch.cuda.memory_reserved() - reserved0)
    print(f"allocated between requests: first {held[0]}, most {max(held)}; device memory "
          f"outside the allocator {outside} more after {len(lengths) - 1} captures")
    assert max(held) <= held[0] + 2**24


def _graph_decode(cfg, B, P, n):
    """Builds ``cfg``, then one graph decode of ``n`` tokens after a
    prompt of B x P; returns the parameters."""
    model = build(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(1, cfg.vocab - 1, (B, P), generator=gen, device="cuda",
                            dtype=torch.int32)
    logits, cache = serve.prefill(model, params, prompts, n)
    serve.decode(model, params, logits, cache, n)
    return params


def test_graph_memory_goes_with_the_parameters_on_the_card(cuda):
    """After a graph decode at full width, the parameters, cache and
    outputs dropped: the device memory allocated returns to its level
    before the model was built, within 64 MB.  That level is taken after a
    SMOKE graph decode, whose parameters are dropped too: what stays of it
    is a cuBLAS workspace for each stream, the decode's and the side
    stream's of the captures, which a process keeps for its life and does
    not pile up (printed)."""
    gc.collect()
    torch.cuda.empty_cache()
    first = torch.cuda.memory_allocated()
    with torch.inference_mode():
        _graph_decode(get_smoke("hymba-1.5b"), 3, 20, 4)   # the parameters go on return
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        before = _counts()
        params = _graph_decode(get_config("hymba-1.5b"), 16, 1024, 16)
        assert _moved(before)["captures"] == 1
        held = torch.cuda.memory_allocated()
        del params
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"allocated: {first} at the start, {base} after a SMOKE graph decode, {held} with "
          f"the full-width parameters, {after} after")
    assert after <= base + 64e6
