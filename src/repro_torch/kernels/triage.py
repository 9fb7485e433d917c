"""Cascade triage + escalation compaction (core C1) on the H100.

One pass over the fleet's tick matrix produces route codes, escalation
buffer slots (stable per-row prefix-sum compaction) and per-row escalated
counts — the per-tick hot path of the SurveilEdge allocator.

* ``triage_fleet`` is the wrapper: a CUDA tensor launches the hand-written
  kernel ``csrc/triage.cu`` (rows resident in warps, ballot/popc prefix
  sums) and bumps ``LAUNCHES``; a CPU tensor runs ``triage_fleet_torch``.
  There is no fallback between the two: a CUDA tensor the kernel cannot
  take raises.
* ``empty_launch`` launches ``csrc/triage.cu``'s empty kernel: the card's
  launch floor, which the kernels' times are read against.
* ``triage_fleet_torch`` is the plain PyTorch version — the same function
  in ``torch.where``/``torch.cumsum``, what the CPU path and the tests run
  and what the kernel is held against on the card.

Both replace ``repro.kernels.triage``'s ``triage_fleet_pallas`` and, as
the one-row case, ``triage_dynamic_pallas``/``triage_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime

#: kernel launches made by ``triage_fleet`` (a CPU call never counts)
LAUNCHES = 0


def triage_fleet_torch(conf: torch.Tensor, thresholds: torch.Tensor, *,
                       capacity: int):
    """conf (R, N) f32, thresholds (R, 2) f32 [alpha, beta] per row ->
    (routes (R, N) i32, slots (R, N) i32, counts (R,) i32)."""
    alpha = thresholds[:, 0:1]
    beta = thresholds[:, 1:2]
    routes = torch.where(conf > alpha, 0,
                         torch.where(conf < beta, 1, 2)).to(torch.int32)
    esc = routes == 2
    pos = torch.cumsum(esc.to(torch.int32), dim=1, dtype=torch.int32) - 1
    slots = torch.where(esc & (pos < capacity), pos, -1).to(torch.int32)
    return routes, slots, esc.sum(dim=1, dtype=torch.int32)


def _check(conf: torch.Tensor, thresholds: torch.Tensor) -> None:
    if conf.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise TypeError(f"triage_fleet takes float32 conf/thresholds, got "
                        f"{conf.dtype}/{thresholds.dtype}")
    if conf.ndim != 2 or thresholds.shape != (conf.shape[0], 2):
        raise ValueError(f"triage_fleet takes conf (R, N) and thresholds "
                         f"(R, 2), got {tuple(conf.shape)} and "
                         f"{tuple(thresholds.shape)}")
    if conf.device != thresholds.device:
        raise ValueError(f"conf on {conf.device} but thresholds on "
                         f"{thresholds.device}")


def triage_fleet(conf: torch.Tensor, thresholds: torch.Tensor, *,
                 capacity: int):
    """Fleet triage on the tensors' device: the CUDA kernel for CUDA
    tensors, ``triage_fleet_torch`` for CPU tensors.

    conf (R, N) f32, thresholds (R, 2) f32 [alpha, beta] per row ->
    (routes (R, N) i32, slots (R, N) i32, counts (R,) i32)."""
    global LAUNCHES
    _check(conf, thresholds)
    if conf.device.type == "cpu":
        return triage_fleet_torch(conf, thresholds, capacity=capacity)
    if conf.device.type != "cuda":
        raise ValueError(f"triage_fleet: no kernel for device {conf.device}")
    rows, n = conf.shape
    if rows == 0 or n == 0:
        raise ValueError(f"triage_fleet: empty conf {tuple(conf.shape)}")
    if not (conf.is_contiguous() and thresholds.is_contiguous()):
        raise ValueError("triage_fleet: conf and thresholds must be "
                         "contiguous")
    routes = torch.empty((rows, n), dtype=torch.int32, device=conf.device)
    slots = torch.empty((rows, n), dtype=torch.int32, device=conf.device)
    counts = torch.empty((rows,), dtype=torch.int32, device=conf.device)
    lib = runtime.library("triage")
    rc = lib.triage_launch(
        conf.data_ptr(), thresholds.data_ptr(), routes.data_ptr(),
        slots.data_ptr(), counts.data_ptr(), rows, n, int(capacity),
        runtime.stream(conf.device))
    runtime.check_launch("triage", rc)
    LAUNCHES += 1
    return routes, slots, counts


def empty_launch(device: torch.device) -> None:
    """One launch of the empty kernel beside the triage kernel (one warp,
    no work) on ``device``'s current stream.  Not counted in
    ``LAUNCHES``: it computes nothing on any path."""
    if device.type != "cuda":
        raise ValueError(f"empty_launch: no kernel for device {device}")
    rc = runtime.library("triage").triage_empty_launch(runtime.stream(device))
    runtime.check_launch("triage", rc)
