"""The fused pixel cascade (paper Eqs. 1-6) on the H100: one launch a tick.

    framediff (Eqs. 1-4) -> 3x3 dilate (Eq. 5) -> 3x3 erode (Eq. 6)
                         -> per-camera foreground count

* ``pixel_cascade`` is the wrapper: CUDA tensors launch the hand-written
  kernel ``csrc/pixel_cascade.cu`` (one block per camera and 32x32 output
  tile, framediff and dilated tiles in shared memory with their halos, so
  neither crosses device memory) and bump ``LAUNCHES``; CPU tensors run
  ``pixel_cascade_torch``.  There is no fallback between the two.
* ``pixel_cascade_torch`` is the plain PyTorch version: the staged
  composition of the plain framediff and 3x3 stencils, then a count.

Both replace ``repro.kernels.pixel_cascade.pixel_cascade_pallas`` /
``_cascade_call``.  The counts are what ``detection.pipeline.detect``
uses to skip connected-component labelling on motionless ticks and
cameras without another pass over the mask.  Boundary semantics are the
staged chain's (framediff 0 and dilated mask ``maxval`` outside the true
image), and the kernel takes the true (H, W): frames are not padded to the
reference's (32, 128) TPU tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.framediff import (check_frames, framediff_torch,
                                           require_launchable)
from repro_torch.kernels.morphology import morph3x3_torch

#: kernel launches made by ``pixel_cascade`` (a CPU call never counts)
LAUNCHES = 0
#: the kernel's grid takes at most this many cameras (CUDA's grid z limit)
MAX_CAMERAS = 65535


def pixel_cascade_torch(f0: torch.Tensor, f1: torch.Tensor,
                        f2: torch.Tensor, *, threshold: int, maxval: int):
    """(B, H, W, 3) int32 frames -> (mask (B, H, W) int32, counts (B,)
    int32 foreground pixels per camera)."""
    fd = framediff_torch(f0, f1, f2, threshold=threshold, maxval=maxval)
    mask = morph3x3_torch(morph3x3_torch(fd, op="max", fill=0),
                          op="min", fill=maxval)
    return mask, (mask > 0).sum(dim=(1, 2), dtype=torch.int32)


def pixel_cascade(f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, *,
                  threshold: int, maxval: int):
    """The fused cascade on the tensors' device: the CUDA kernel for CUDA
    tensors, ``pixel_cascade_torch`` for CPU tensors.

    (B, H, W, 3) int32 frames in [0, 255] -> (mask (B, H, W) int32 in
    {0, maxval}, counts (B,) int32)."""
    global LAUNCHES
    check_frames("pixel_cascade", f0, f1, f2)
    if f0.device.type == "cpu":
        return pixel_cascade_torch(f0, f1, f2, threshold=threshold,
                                   maxval=maxval)
    if f0.device.type != "cuda":
        raise ValueError(f"pixel_cascade: no kernel for device {f0.device}")
    require_launchable("pixel_cascade", f0, f1, f2)
    B, H, W, _ = f0.shape
    if B > MAX_CAMERAS:
        raise ValueError(f"pixel_cascade: at most {MAX_CAMERAS} cameras a "
                         f"launch, got {B}")
    mask = torch.empty((B, H, W), dtype=torch.int32, device=f0.device)
    counts = torch.empty((B,), dtype=torch.int32, device=f0.device)
    rc = runtime.library("pixel_cascade").pixel_cascade_launch(
        f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), mask.data_ptr(),
        counts.data_ptr(), B, H, W, int(threshold), int(maxval),
        runtime.stream(f0.device))
    runtime.check_launch("pixel_cascade", rc)
    LAUNCHES += 1
    return mask, counts
