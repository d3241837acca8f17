"""The traffic's token generator: a Zipf-distributed synthetic corpus, a
pure function of (seed, step).  A frozen copy of the program's
``data/pipeline.py`` ``SyntheticTokens``, with the interface the training
loop drives (``next`` and the resumable state), so that a later change to
the program cannot move the yardstick."""
from __future__ import annotations

import json

import numpy as np


def zipf_tokens(seed: int, step: int, shape, vocab: int, a: float) -> np.ndarray:
    """int32 tokens in [1, vocab - 2] of ``shape``, Zipf(a) ranks folded
    into the vocabulary, drawn from (seed, step) alone."""
    rng = np.random.default_rng((seed << 20) ^ step)
    z = rng.zipf(a, size=shape)
    return (z % (vocab - 2)).astype(np.int32) + 1


class SyntheticTokens:
    """Batches (batch, seq) of :func:`zipf_tokens`, step after step."""

    def __init__(self, vocab: int, batch: int, seq: int, *, seed: int, a: float = 1.3):
        self.vocab, self.batch, self.seq, self.seed, self.a = vocab, batch, seq, seed, a
        self.step = 0

    def batch_at(self, step: int) -> np.ndarray:
        return zipf_tokens(self.seed, step, (self.batch, self.seq), self.vocab, self.a)

    def next(self) -> dict:
        tokens = self.batch_at(self.step)
        self.step += 1
        return {"tokens": tokens}

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state(self, state: dict) -> None:
        if state["seed"] != self.seed:
            raise ValueError(f"corpus seed {state['seed']} is not {self.seed}")
        self.step = state["step"]

    def save_state(self, fs, path: str = "/datapipe.json") -> None:
        fd = fs.open(path)
        fs.pwrite(fd, json.dumps(self.state()).encode().ljust(256), 0)
        fs.close(fd)

    def restore_state(self, fs, path: str = "/datapipe.json") -> bool:
        fd = fs.open(path)
        raw = fs.pread(fd, 256, 0)
        fs.close(fd)
        if not raw.strip():
            return False
        self.load_state(json.loads(raw.decode()))
        return True
