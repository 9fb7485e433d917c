"""Confidence-thresholded cloud-edge cascade (the paper's C1).

The edge (CQ-specific) model emits a confidence f = P(query object | crop
or prompt).  Per item:
    f > alpha          -> accept at the edge
    f < beta           -> reject at the edge
    beta <= f <= alpha -> escalate: re-classify (or decode) with the cloud
                          model

The query pipeline routes its ticks with the triage kernel
(``kernels/triage.py``); the serving launcher routes a request batch with
``triage`` and gathers the escalated prompts with ``compact_escalated``,
as the reference's ``core/cascade.py`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

ACCEPT, REJECT, ESCALATE = 0, 1, 2


def confidence_from_logits(logits: torch.Tensor,
                           query_class: int = 1) -> torch.Tensor:
    """(B, C) class logits -> (B,) P(query object)."""
    return torch.softmax(logits.to(torch.float32), dim=-1)[:, query_class]


def triage(conf: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """(B,) confidences -> (B,) int32 route codes {ACCEPT, REJECT,
    ESCALATE}."""
    return torch.where(conf > alpha, ACCEPT,
                       torch.where(conf < beta, REJECT, ESCALATE)
                       ).to(torch.int32)


def compact_escalated(routes: torch.Tensor, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable-compact the indices of escalated items into a fixed buffer.

    Returns (indices (capacity,) int32 — the source index a slot holds,
    0 in the slots past the escalated count; valid (capacity,) bool;
    n_escalated () int32).  Items past ``capacity`` stay un-escalated."""
    esc = routes == ESCALATE
    n = esc.sum(dtype=torch.int32)
    src = torch.nonzero(esc).flatten()[:capacity].to(torch.int32)
    idx = torch.zeros((capacity,), dtype=torch.int32, device=routes.device)
    idx[:src.numel()] = src
    valid = torch.arange(capacity, device=routes.device) < torch.clamp(
        n, max=capacity)
    return idx, valid, n
