"""3x3 dilation / erosion (paper Eqs. 5-6) on the H100.

One stencil with an ``op`` and a ``fill``: each output pixel is the max or
min of its 3x3 neighbourhood, a neighbour outside the (H, W) image reading
as ``fill``.  ``dilate3x3`` binds it to max with fill 0, ``erode3x3`` to
min with fill ``maxval`` — the two bindings of the reference's one
``_morph_pallas`` launcher.

* ``morph3x3`` is the wrapper: a CUDA tensor launches the hand-written
  kernel ``csrc/morphology.cu`` (a block a 128 x 16 tile staged with its
  halo and the fill in shared memory, a row pass then a column pass, 4
  outputs a thread) and bumps ``LAUNCHES``; a CPU tensor runs
  ``morph3x3_torch``.  There is no fallback between the two.
* ``morph3x3_torch`` is the plain PyTorch version: pad with ``fill``, then
  nine shifted slices.

Both replace ``repro.kernels.morphology._morph_pallas`` and its bindings
``dilate3x3_pallas`` / ``erode3x3_pallas``: the second and third launches
of the staged chain behind ``ops.pixel_cascade(fused=False)``.  The
reference's host-side ``halo_bands`` gather is not needed: each block
loads its own halo and applies the fill as it loads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.framediff import require_launchable

#: the kernel's ``op`` argument
OPS = {"max": 0, "min": 1}

#: kernel launches made by ``morph3x3`` (a CPU call never counts)
LAUNCHES = 0


def morph3x3_torch(x: torch.Tensor, *, op: str, fill: int) -> torch.Tensor:
    """(B, H, W) int32 -> (B, H, W) int32 3x3 max/min, ``fill`` outside."""
    red = torch.maximum if op == "max" else torch.minimum
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1), value=fill)
    acc = xp[:, 1:1 + H, 1:1 + W]
    for dy in range(3):
        for dx in range(3):
            acc = red(acc, xp[:, dy:dy + H, dx:dx + W])
    return acc


def morph3x3(x: torch.Tensor, *, op: str, fill: int) -> torch.Tensor:
    """3x3 max/min on the tensor's device: the CUDA kernel for a CUDA
    tensor, ``morph3x3_torch`` for a CPU tensor.

    (B, H, W) int32 -> (B, H, W) int32."""
    global LAUNCHES
    if op not in OPS:
        raise ValueError(f"morph3x3: op must be 'max' or 'min', got {op!r}")
    if x.dtype != torch.int32 or x.ndim != 3:
        raise ValueError(f"morph3x3 takes an int32 (B, H, W) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return morph3x3_torch(x, op=op, fill=fill)
    if x.device.type != "cuda":
        raise ValueError(f"morph3x3: no kernel for device {x.device}")
    require_launchable("morph3x3", x)
    B, H, W = x.shape
    if H * W >= 1 << 31:
        raise ValueError(f"morph3x3: frames of under 2^31 pixels, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    rc = runtime.library("morphology").morphology_launch(
        x.data_ptr(), out.data_ptr(), B, H, W, OPS[op], int(fill),
        runtime.stream(x.device))
    runtime.check_launch("morphology", rc)
    LAUNCHES += 1
    return out


def dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """Eq. 5: 3x3 max, zero outside the image."""
    return morph3x3(x, op="max", fill=0)


def erode3x3(x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """Eq. 6: 3x3 min, ``maxval`` outside the image."""
    return morph3x3(x, op="min", fill=maxval)
