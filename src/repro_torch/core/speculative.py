"""Greedy decoding with the cloud model: the oracle of the serving tests.

Of the reference's ``core/speculative.py`` (cascade speculative decoding:
an edge draft model proposes tokens, the cloud model verifies them in one
pass) the port carries only ``greedy`` and ``cloud_greedy_generate``,
plain greedy decoding with the big model, which the continuous-batching
engine must reproduce token for token.  The speculative decoder itself
comes with a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...) int32 argmax (the first maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def cloud_greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                          steps: int, cache_len: Optional[int] = None
                          ) -> torch.Tensor:
    """prompt (B, S) -> (B, steps + 1) greedy tokens: the prefill's, then
    one per decode step."""
    B, S = prompt.shape
    cache_len = max(cache_len or 0, S + steps + 2)
    logits, cache = T.prefill(cfg, params, prompt, cache_len=cache_len)
    out = [greedy(logits)]
    for _ in range(steps):
        logits, cache = T.decode_step(cfg, params, cache, out[-1])
        out.append(greedy(logits))
    return torch.stack(out[:steps + 1], dim=1)
