"""Confidence of the cascade's edge model (the paper's C1).

The edge (CQ-specific) model emits a confidence f = P(query object | crop);
the triage kernel (``kernels/triage.py``) then routes each item by the
Eqs. 8-9 thresholds.  Of the reference's ``core/cascade.py`` the pixel
path needs only ``confidence_from_logits``.
"""
from __future__ import annotations

import torch


def confidence_from_logits(logits: torch.Tensor,
                           query_class: int = 1) -> torch.Tensor:
    """(B, C) class logits -> (B,) P(query object)."""
    return torch.softmax(logits.to(torch.float32), dim=-1)[:, query_class]
