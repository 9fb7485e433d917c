"""Query-accuracy scoring.

The paper reports F2 (recall-weighted F-measure) against the cloud model's
output treated as ground truth.  Kept in one place so the guard behaviour
(empty classes, zero denominators) cannot diverge between
``repro_torch.serving.simulator.SimResult`` and
``repro_torch.system.QueryReport``.
"""
from __future__ import annotations

import numpy as np


def f_score_counts(tp: int, fp: int, fn: int, lam: float = 2.0) -> float:
    """F_lambda from confusion counts — the one formula both the
    array path and the streaming aggregates (``metrics.StreamingWindows``)
    reduce to, so windowed and whole-run scores cannot diverge."""
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    if p + r == 0:
        return 0.0
    return (1 + lam ** 2) * p * r / (lam ** 2 * p + r)


def f_score(decisions: np.ndarray, truths: np.ndarray,
            lam: float = 2.0) -> float:
    """F_lambda of boolean decisions vs boolean ground truth."""
    decisions = np.asarray(decisions, bool)
    truths = np.asarray(truths, bool)
    tp = int(np.sum(decisions & truths))
    fp = int(np.sum(decisions & ~truths))
    fn = int(np.sum(~decisions & truths))
    return f_score_counts(tp, fp, fn, lam)
