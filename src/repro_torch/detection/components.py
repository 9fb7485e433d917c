"""Connected-component labeling + bounding boxes (the contour substitute).

The paper retrieves contours with Suzuki border-following — sequential
pointer-chasing.  Like the reference, the port uses iterative min-label
propagation (a data-parallel fixpoint: every foreground pixel takes the
min label of its 8-neighbourhood until nothing changes), which yields
identical bounding boxes for the pipeline's purpose.

``label_components`` is the reference's ``lax.while_loop`` written as a
PyTorch loop on the mask's device; it is not a Pallas kernel in the
reference, so it stays plain PyTorch here.  Testing for a change reads
one flag back to the host per iteration.  ``Box`` and ``extract_boxes``
are host numpy, copied from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

#: label of a background pixel during the fixpoint (above any H*W index)
BIG = 1 << 30

#: the eight neighbour shifts of the 3x3 neighbourhood
_SHIFTS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                if (dy, dx) != (0, 0))


def _shifted(lab: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``lab`` rolled by (dy, dx) over (H, W), vacated cells set to BIG."""
    sh = torch.roll(lab, (dy, dx), dims=(1, 2))
    if dy > 0:
        sh[:, :dy, :] = BIG
    elif dy < 0:
        sh[:, dy:, :] = BIG
    if dx > 0:
        sh[:, :, :dx] = BIG
    elif dx < 0:
        sh[:, :, dx:] = BIG
    return sh


def label_components(mask: torch.Tensor, max_iters: int = 256
                     ) -> torch.Tensor:
    """mask (B, H, W) {0, nonzero} -> labels (B, H, W) int32 (-1 on the
    background), on the mask's device.

    The label of a component is the min linear index of its pixels."""
    B, H, W = mask.shape
    fg = mask > 0
    idx = torch.arange(H * W, dtype=torch.int32, device=mask.device)
    lab = torch.where(fg, idx.reshape(1, H, W), BIG).to(torch.int32)
    for _ in range(max_iters):
        new = lab
        for dy, dx in _SHIFTS:
            new = torch.minimum(new, _shifted(lab, dy, dx))
        new = torch.where(fg, new, BIG)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    return torch.where(fg, lab, -1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Box:
    y0: int
    x0: int
    y1: int
    x1: int
    area: int

    @property
    def h(self) -> int:
        return self.y1 - self.y0 + 1

    @property
    def w(self) -> int:
        return self.x1 - self.x0 + 1


def extract_boxes(labels: np.ndarray, *, min_area: int = 12,
                  max_aspect: float = 6.0) -> List[Box]:
    """Host-side bbox extraction + the paper's size/aspect filtering.

    Discards detections that are too small or too elongated (disturbance /
    noise), per §IV-C.
    """
    out: List[Box] = []
    lab = np.asarray(labels)
    fg = lab >= 0
    if not fg.any():
        return out
    for lid in np.unique(lab[fg]):
        ys, xs = np.nonzero(lab == lid)
        b = Box(int(ys.min()), int(xs.min()), int(ys.max()), int(xs.max()),
                int(len(ys)))
        if b.area < min_area:
            continue
        aspect = max(b.h, b.w) / max(min(b.h, b.w), 1)
        if aspect > max_aspect:
            continue
        out.append(b)
    return out
