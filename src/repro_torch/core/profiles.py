"""Camera profiles + context-specific dataset establishment (paper §IV-A/B).

Offline stage: leisure-time frames from each camera are labeled by the
high-accuracy cloud pipeline (detector + classifier); per-camera proportion
vectors feed K-means (``core/clustering.py``, on the CPU); cameras in one
cluster share a training dataset.

Online stage (new query): positive samples are labeled images of the query
class; negative samples are drawn from non-query classes *proportionally to
the cluster profile* — the paper's principle that commonly-seen objects
deserve more negative mass.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import clustering


def build_profiles(camera_labels: Dict[int, np.ndarray],
                   num_classes: int) -> Tuple[List[int], np.ndarray]:
    """{camera_id: (N_i,) labels} -> (camera_ids, (n_cams, C) profiles)."""
    cams = sorted(camera_labels)
    profs = np.stack([
        clustering.proportion_vector(
            torch.as_tensor(np.asarray(camera_labels[c], dtype=np.int32)),
            num_classes).numpy()
        for c in cams])
    return cams, profs


def cluster_cameras(profiles: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """K-means wrapper -> (assignments, cluster profiles/centers)."""
    assign, centers, _ = clustering.kmeans(torch.as_tensor(profiles), k)
    return assign.numpy(), centers.numpy()


def select_training_set(labels: np.ndarray,
                        cluster_profile: np.ndarray,
                        query_class: int,
                        n_positive: int,
                        n_negative: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Indices of the CQ-specific fine-tuning set.

    Negative sampling mass per non-query class c is proportional to the
    cluster profile entry (common objects get more negatives).
    """
    pos_pool = np.flatnonzero(labels == query_class)
    neg_pool = np.flatnonzero(labels != query_class)
    if len(pos_pool) == 0 or len(neg_pool) == 0:
        raise ValueError("query class absent from the cluster dataset")
    pos = rng.choice(pos_pool, size=min(n_positive, len(pos_pool)),
                     replace=len(pos_pool) < n_positive)
    w = cluster_profile[labels[neg_pool]].astype(np.float64)
    w = np.maximum(w, 1e-9)
    w = w / w.sum()
    neg = rng.choice(neg_pool, size=n_negative, replace=True, p=w)
    idx = np.concatenate([pos, neg])
    rng.shuffle(idx)
    return idx
