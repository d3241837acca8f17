"""A run with the program broken underneath comes out not correct.  Each
test skips the look for a card and drives the rest of a run on the CPU
(``bench.run.measure``) at SMOKE size, with one fault planted in the
program where the timed path produces its result:

* training: a step that leaves its state unchanged; half of each batch
  left out, the loss's mean taken over the rest;
* serving: a served token altered where it is produced (the first, to
  the token the program ranks last); half of each batch left out, its
  rows answered with the other half's.

One card runs each cell, so no exchange between cards can be left out.
The sound run of each cell comes out correct."""
from __future__ import annotations

import pytest
import torch

from bench import run

SEED = 2**31 + 8191
TRAIN = ("mamba2-780m.train_4k", "hymba-1.5b.train_4k")
SERVE = ("mamba2-780m.serve_longdoc", "hymba-1.5b.serve_longdoc")


def _measure(root, workload):
    return run.measure(workload, SEED, 0.0, False, device="cpu", root=root)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(smoke_root, workload):
    out = _measure(smoke_root, workload)
    assert out["correct"], out["checks"]
    assert list(out)[-2:] == ["checks", "_numbers"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(smoke_root, workload, monkeypatch):
    from repro_torch.optim.adamw import AdamW

    def unchanged(self, grads, state, params):
        return {"grad_norm": torch.zeros(())}

    monkeypatch.setattr(AdamW, "update", unchanged)
    out = _measure(smoke_root, workload)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(smoke_root, workload, monkeypatch):
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(cfg, params, batch, **kw):
        return loss_fn(cfg, params, {"tokens": batch["tokens"][:batch["tokens"].shape[0] // 2]},
                       **kw)

    monkeypatch.setattr(lm, "loss_fn", half)
    assert not _measure(smoke_root, workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_served_token_altered(smoke_root, workload, monkeypatch):
    from repro_torch.launch import serve
    decode = serve.decode

    def altered(model, params, logits, cache, n):
        tokens, last = decode(model, params, logits, cache, n)
        tokens[:, 0] = torch.argmin(logits[:, -1], -1).to(tokens.dtype)   # ranked last
        return tokens, last

    monkeypatch.setattr(serve, "decode", altered)
    out = _measure(smoke_root, workload)
    assert not out["correct"] and out["checks"]["served_gap"]["value"] > 0


@pytest.mark.parametrize("workload", SERVE)
def test_half_of_the_serving_batch_left_out(smoke_root, workload, monkeypatch):
    from repro_torch.launch import serve
    prefill = serve.prefill

    def half(model, params, prompts, n):
        h = prompts.shape[0] // 2
        return prefill(model, params, torch.cat([prompts[:h], prompts[:h]]), n)

    monkeypatch.setattr(serve, "prefill", half)
    assert not _measure(smoke_root, workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_lost_log_line(smoke_root, workload, monkeypatch):
    """An acknowledged line that does not read back fails the run."""
    from bench.harness.durable import TimedFS
    lost = TimedFS.lost
    monkeypatch.setattr(TimedFS, "lost", lambda self: lost(self) + 1)
    out = _measure(smoke_root, workload)
    assert not out["correct"] and out["checks"]["log_lost"]["value"] == 1
