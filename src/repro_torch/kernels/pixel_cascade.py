"""The fused pixel cascade (paper Eqs. 1-6) on the H100: one device
operation a tick.

    framediff (Eqs. 1-4) -> 3x3 dilate (Eq. 5) -> 3x3 erode (Eq. 6)
                         -> per-camera foreground count

* ``pixel_cascade`` is the wrapper: CUDA tensors launch the hand-written
  kernel ``csrc/pixel_cascade.cu`` and bump ``LAUNCHES``; CPU tensors run
  ``pixel_cascade_torch``.  There is no fallback between the two.  The
  kernel reads uint8 or int32 frames as they are, the strided views
  ``detect`` takes of one (B, 3, H, W, 3) batch included, stages each
  tile's halo rows in shared memory, packs the motion bits of a tile row
  into one word, dilates and erodes with word operations, and counts each
  camera's foreground with one atomic a block into ``_workspace``, a
  buffer this module zeroes once and the kernel leaves zeroed.
* ``pixel_cascade_torch`` is the plain PyTorch version: the staged
  composition of the plain framediff and 3x3 stencils, then a count.

Both replace ``repro.kernels.pixel_cascade.pixel_cascade_pallas`` /
``_cascade_call``, and the int32 widening of the reference's wrapper.
The counts are what ``detection.pipeline.detect`` uses to skip
connected-component labelling on motionless ticks and cameras without
another pass over the mask.  Boundary semantics are the staged chain's
(framediff 0 and dilated mask ``maxval`` outside the true image), and the
kernel takes the true (H, W): frames are not padded to the reference's
(32, 128) TPU tile.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.framediff import (check_frames, framediff_torch,
                                           require_launchable)
from repro_torch.kernels.morphology import morph3x3_torch

#: kernel launches made by ``pixel_cascade`` (a CPU call never counts)
LAUNCHES = 0
#: the kernel's grid takes at most this many cameras (CUDA's grid z limit)
MAX_CAMERAS = 65535
#: the frame element types the kernel reads (an instance each)
FRAME_DTYPES = (torch.uint8, torch.int32)
#: (device index, stream) -> the per-camera count words of the kernel's
#: last-block reduction, zeroed at allocation and left zeroed by each call
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def pixel_cascade_torch(f0: torch.Tensor, f1: torch.Tensor,
                        f2: torch.Tensor, *, threshold: int, maxval: int):
    """(B, H, W, 3) uint8 or int32 frames -> (mask (B, H, W) int32, counts
    (B,) int32 foreground pixels per camera).  uint8 frames widen to int32
    before any subtraction (uint8 differences would wrap)."""
    f0, f1, f2 = (f.to(torch.int32) for f in (f0, f1, f2))
    fd = framediff_torch(f0, f1, f2, threshold=threshold, maxval=maxval)
    mask = morph3x3_torch(morph3x3_torch(fd, op="max", fill=0),
                          op="min", fill=maxval)
    return mask, (mask > 0).sum(dim=(1, 2), dtype=torch.int32)


def _workspace(device: torch.device, stream: int, batch: int) -> torch.Tensor:
    """At least ``batch`` zeroed int64 count words for launches on
    ``stream``: allocated (one device memset) only when a call needs more
    cameras than any before it on that stream."""
    key = (device.index, stream)
    acc = _WORKSPACE.get(key)
    if acc is None or acc.numel() < batch:
        acc = torch.zeros((batch,), dtype=torch.int64, device=device)
        _WORKSPACE[key] = acc
    return acc


def pixel_cascade(f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, *,
                  threshold: int, maxval: int):
    """The fused cascade on the tensors' device: the CUDA kernel for CUDA
    tensors, ``pixel_cascade_torch`` for CPU tensors.

    (B, H, W, 3) uint8 or int32 frames in [0, 255], each camera's
    (H, W, 3) block contiguous and the cameras any distance apart ->
    (mask (B, H, W) int32 in {0, maxval}, counts (B,) int32)."""
    global LAUNCHES
    check_frames("pixel_cascade", f0, f1, f2, dtypes=FRAME_DTYPES,
                 camera_stride=True)
    if f0.device.type == "cpu":
        return pixel_cascade_torch(f0, f1, f2, threshold=threshold,
                                   maxval=maxval)
    if f0.device.type != "cuda":
        raise ValueError(f"pixel_cascade: no kernel for device {f0.device}")
    require_launchable("pixel_cascade", f0, f1, f2, contiguous=False)
    B, H, W, _ = f0.shape
    if B > MAX_CAMERAS:
        raise ValueError(f"pixel_cascade: at most {MAX_CAMERAS} cameras a "
                         f"launch, got {B}")
    if H * W * 3 >= 1 << 31:
        raise ValueError(f"pixel_cascade: a {H}x{W} frame exceeds the "
                         f"kernel's 32-bit index")
    stream = runtime.stream(f0.device)
    mask = torch.empty((B, H, W), dtype=torch.int32, device=f0.device)
    counts = torch.empty((B,), dtype=torch.int32, device=f0.device)
    acc = _workspace(f0.device, stream, B)
    rc = runtime.library("pixel_cascade").pixel_cascade_launch(
        f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), acc.data_ptr(), B, H, W, int(threshold),
        int(maxval), f0.element_size(), f0.stride(0), f1.stride(0),
        f2.stride(0), stream)
    runtime.check_launch("pixel_cascade", rc)
    LAUNCHES += 1
    return mask, counts
