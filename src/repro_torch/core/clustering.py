"""Camera profiling + K-means clustering (paper §IV-A), in PyTorch.

A camera's *profile* is its proportion vector: occurrence frequencies of
object classes across its leisure-time frames (labeled by the high-accuracy
cloud models).  Cameras are clustered on profiles with K-means; each cluster
shares one context-specific training dataset.

Both functions run on the device of their input, in f32, with the
reference's arithmetic: the same farthest-point init, the same 50 EM steps,
empty clusters kept where they were, and first-index ties in ``argmin`` /
``argmax``, so assignments agree exactly and centers to f32 rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch


def proportion_vector(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """labels: (N,) int detected-object classes -> (C,) f32 frequencies."""
    counts = torch.zeros((num_classes,), dtype=torch.float32,
                         device=labels.device)
    counts.index_add_(0, labels.long(),
                      torch.ones(labels.shape, dtype=torch.float32,
                                 device=labels.device))
    return counts / torch.clamp(torch.sum(counts), min=1.0)


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, C), (k, C) -> (N, k) squared Euclidean distances."""
    return torch.sum((x[:, None, :] - centers[None]) ** 2, dim=-1)


def kmeans(profiles: torch.Tensor, k: int, *, iters: int = 50
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-means on (N, C) profiles.

    Returns (assignments (N,) int32, centers (k, C) f32, inertia ()).  The
    init is deterministic farthest-point (k-means++ without randomness):
    center 0 is profile 0, each next center the profile farthest from the
    centers chosen so far.  (The reference's ``key`` argument is never
    read, so the port does not take one.)
    """
    x = profiles.to(torch.float32)
    centers = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    centers[0] = x[0]
    for chosen in range(1, k):
        d = torch.amin(_sq_dists(x, centers[:chosen]), dim=1)
        centers[chosen] = x[torch.argmax(d)]

    for _ in range(iters):
        assign = torch.argmin(_sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        sizes = torch.sum(onehot, dim=0)
        new_centers = (onehot.T @ x) / torch.clamp(sizes, min=1e-9)[:, None]
        # keep empty clusters where they were
        centers = torch.where(sizes[:, None] > 0, new_centers, centers)
    d = _sq_dists(x, centers)
    assign = torch.argmin(d, dim=1).to(torch.int32)
    inertia = torch.sum(torch.amin(d, dim=1))
    return assign, centers, inertia
