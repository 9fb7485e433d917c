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
as the reference's ``core/cascade.py`` does.  ``cascade_batch`` runs both
models over one batch, and ``CascadePair`` wires two models together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

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


def cascade_batch(edge_conf: torch.Tensor,
                  cloud_fn: Callable[[torch.Tensor], torch.Tensor],
                  items: torch.Tensor,
                  alpha: float, beta: float,
                  capacity: int) -> Dict[str, torch.Tensor]:
    """The cascade over one batch.

    edge_conf: (B,) edge confidences; items: (B, ...) payloads to send to
    ``cloud_fn`` (which maps (capacity, ...) -> (capacity,) confidences).
    Returns dict with final decisions (B,), routes, and stats.  An
    escalated item takes the cloud's decision (conf > 0.5); the padded
    slots past the escalated count write nothing.
    """
    B = edge_conf.shape[0]
    routes = triage(edge_conf, alpha, beta)
    idx, valid, n_esc = compact_escalated(routes, capacity)
    esc_items = torch.index_select(items, 0, idx)
    cloud_dec = cloud_fn(esc_items) > 0.5                # (capacity,)
    final = routes == ACCEPT                             # edge accepts
    final[idx[valid].long()] = cloud_dec[valid]
    return {
        "decision": final,                               # (B,) bool: query object?
        "routes": routes,
        "edge_conf": edge_conf,
        "n_escalated": n_esc,
        "escalated_frac": n_esc / B,
    }


@dataclasses.dataclass
class CascadePair:
    """An (edge CQ-specific model, cloud high-accuracy model) pair."""
    edge_cfg: Any
    cloud_cfg: Any
    edge_apply: Callable      # (params, batch) -> (B, C) logits
    cloud_apply: Callable
    query_class: int = 1

    def edge_confidence(self, edge_params, batch) -> torch.Tensor:
        return confidence_from_logits(
            self.edge_apply(edge_params, batch), self.query_class)

    def cloud_confidence(self, cloud_params, batch) -> torch.Tensor:
        return confidence_from_logits(
            self.cloud_apply(cloud_params, batch), self.query_class)
