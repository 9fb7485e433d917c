"""Three-frame difference motion mask (paper Eqs. 1-4) on the H100.

    D1 = |f1 - f0|, D2 = |f2 - f1|, Da = D1 & D2 (bitwise, per channel)
    gray = (299 r + 587 g + 114 b) // 1000, mask = maxval if gray > threshold

* ``framediff`` is the wrapper: a CUDA tensor launches the hand-written
  kernel ``csrc/framediff.cu`` (one thread a pixel) and bumps
  ``LAUNCHES``; a CPU tensor runs ``framediff_torch``.  There is no
  fallback between the two.
* ``framediff_torch`` is the plain PyTorch version.

Both replace ``repro.kernels.framediff.framediff_pallas``, the first
launch of the staged chain that ``ops.pixel_cascade(fused=False)`` keeps
as the differential reference of the fused cascade.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

#: kernel launches made by ``framediff`` (a CPU call never counts)
LAUNCHES = 0


def framediff_torch(f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, *,
                    threshold: int, maxval: int) -> torch.Tensor:
    """(B, H, W, 3) int32 frames in [0, 255] -> (B, H, W) int32 mask in
    {0, maxval}."""
    da = (f1 - f0).abs() & (f2 - f1).abs()
    gray = (da[..., 0] * 299 + da[..., 1] * 587 + da[..., 2] * 114) // 1000
    return torch.where(gray > threshold, maxval, 0).to(torch.int32)


def check_frames(name: str, *frames: torch.Tensor,
                 dtypes=(torch.int32,), camera_stride: bool = False) -> None:
    """Raise unless the frames are (B, H, W, 3) of one shape, one dtype
    out of ``dtypes`` and one device (shared with the fused cascade's
    wrapper).  With ``camera_stride`` a frame's cameras may lie any
    distance apart, but each camera's (H, W, 3) block must be contiguous."""
    f0 = frames[0]
    for f in frames:
        if f.dtype not in dtypes or f.dtype != f0.dtype:
            want = " or ".join(str(d).rsplit(".", 1)[-1] for d in dtypes)
            raise TypeError(f"{name} takes {want} frames of one dtype, got "
                            f"{[x.dtype for x in frames]}")
        if f.ndim != 4 or f.shape[-1] != 3 or f.shape != f0.shape:
            raise ValueError(f"{name} takes three (B, H, W, 3) frames of one "
                             f"shape, got {[tuple(x.shape) for x in frames]}")
        if f.device != f0.device:
            raise ValueError(f"{name}: frames on {f0.device} and {f.device}")
        if camera_stride and f.shape[0] and not f[0].is_contiguous():
            raise ValueError(f"{name}: each camera's (H, W, 3) block must be "
                             f"contiguous, got strides {f.stride()}")


def require_launchable(name: str, *tensors: torch.Tensor,
                       contiguous: bool = True) -> None:
    """Raise unless the CUDA tensors can go to a kernel as they are:
    non-empty and, unless the kernel takes strides (``contiguous=False``),
    contiguous."""
    for t in tensors:
        if t.numel() == 0:
            raise ValueError(f"{name}: empty input {tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def framediff(f0: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, *,
              threshold: int, maxval: int) -> torch.Tensor:
    """Framediff on the tensors' device: the CUDA kernel for CUDA tensors,
    ``framediff_torch`` for CPU tensors.

    (B, H, W, 3) int32 frames in [0, 255] -> (B, H, W) int32 mask."""
    global LAUNCHES
    check_frames("framediff", f0, f1, f2)
    if f0.device.type == "cpu":
        return framediff_torch(f0, f1, f2, threshold=threshold, maxval=maxval)
    if f0.device.type != "cuda":
        raise ValueError(f"framediff: no kernel for device {f0.device}")
    require_launchable("framediff", f0, f1, f2)
    B, H, W, _ = f0.shape
    if B * H * W >= 1 << 31:
        raise ValueError(f"framediff: {B * H * W} pixels exceed the "
                         f"kernel's int pixel count")
    out = torch.empty((B, H, W), dtype=torch.int32, device=f0.device)
    rc = runtime.library("framediff").framediff_launch(
        f0.data_ptr(), f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
        B * H * W, int(threshold), int(maxval), runtime.stream(f0.device))
    runtime.check_launch("framediff", rc)
    LAUNCHES += 1
    return out
