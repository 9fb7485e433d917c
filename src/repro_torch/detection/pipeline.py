"""The full moving-object detection stage (paper §IV-C), end to end.

frames -> fused pixel cascade (ONE kernel launch: framediff + dilate +
erode + foreground count) -> CCL -> filtered bounding boxes -> crops
ready for the cascade classifier.

``fused=False`` runs the staged chain — framediff, dilate and erode as
three launches — as the differential reference; ``device="cpu"`` runs
every kernel's plain PyTorch version.  The cascade's per-camera
foreground counts let ``detect`` skip the CCL fixpoint entirely on
motionless ticks and skip box extraction for motionless cameras without
re-reducing the mask.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.detection import components
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class Detection:
    box: components.Box
    crop: np.ndarray          # (ch, cw, 3) uint8-valued


def motion_mask(f0, f1, f2, *, threshold: int = 40, fused: bool = True,
                device="cuda") -> torch.Tensor:
    """Eqs. 1-6: framediff + dilate + erode.  (B,H,W,3)x3 -> (B,H,W)."""
    mask, _ = ops.pixel_cascade(f0, f1, f2, threshold=threshold,
                                fused=fused, device=device)
    return mask


def detect(frames: np.ndarray, *, threshold: int = 40, crop: int = 32,
           min_area: int = 12, fused: bool = True, device="cuda"
           ) -> List[List[Detection]]:
    """frames: (3, H, W, 3) consecutive triple (or (B, 3, H, W, 3)).

    Returns, per batch item, the filtered detections of the middle frame.
    The frames cross to the device once, as they are (uint8 for rendered
    frames)."""
    arr = np.asarray(frames)
    if arr.ndim == 4:
        arr = arr[None]
    B = arr.shape[0]
    dev = resolve_device(device)
    batch = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    mask, counts = ops.pixel_cascade(batch[:, 0], batch[:, 1], batch[:, 2],
                                     threshold=threshold, fused=fused,
                                     device=dev)
    counts_np = counts.cpu().numpy()
    if not counts_np.any():
        # motionless tick: no foreground anywhere — skip the CCL fixpoint
        return [[] for _ in range(B)]
    labels_np = components.label_components(mask).cpu().numpy()
    out: List[List[Detection]] = []
    for b in range(B):
        if counts_np[b] == 0:
            out.append([])        # motionless camera: no boxes to extract
            continue
        boxes = components.extract_boxes(labels_np[b], min_area=min_area)
        dets = []
        for box in boxes:
            cy = (box.y0 + box.y1) // 2
            cx = (box.x0 + box.x1) // 2
            half = crop // 2
            y0 = np.clip(cy - half, 0, arr.shape[2] - crop)
            x0 = np.clip(cx - half, 0, arr.shape[3] - crop)
            dets.append(Detection(
                box, arr[b, 1, y0:y0 + crop, x0:x0 + crop]))
        out.append(dets)
    return out
