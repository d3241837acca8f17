"""The reference's reading of served tokens: one full float32 forward over
a prompt and the tokens served after it, and at each served position the
gap by which the served token's logit lies below the best logit there.
Greedy decoding in exact arithmetic serves gap 0."""
from __future__ import annotations

import torch

from bench.reference import model as ref


@torch.no_grad()
def served_gaps(m, params, prompt, served, mm=ref.f32_mm):
    """prompt: (P,) tokens; served: (n,) tokens.  Returns (n,) float32
    gaps: max logit minus the served token's logit, the logits at the
    position before each served token."""
    tokens = torch.cat([prompt, served])[None, :-1]
    n = served.shape[0]
    x = ref.hidden(m, params, tokens, mm)[:, -n:]
    logits = ref.unembed(m, params, x, ref.f32_mm)[0]
    return logits.amax(-1) - logits.gather(-1, served.long()[:, None])[:, 0]


@torch.no_grad()
def control_gaps(m, params, prompt, served, mm):
    """The control: at the same positions, the gap (in the float32
    logits) of the token that the forward through ``mm`` puts first."""
    tokens = torch.cat([prompt, served])[None, :-1]
    n = served.shape[0]
    low = ref.unembed(m, params, ref.hidden(m, params, tokens, mm)[:, -n:], mm)[0]
    logits = ref.unembed(m, params, ref.hidden(m, params, tokens)[:, -n:])[0]
    return logits.amax(-1) - logits.gather(-1, low.argmax(-1)[:, None])[:, 0]
