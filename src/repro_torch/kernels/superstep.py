"""Scan superstep (Eqs. 8-9 over S ticks, then fleet triage) on the H100.

One launch covers a boundary-free run of S scheduler ticks: per (query,
edge) row the Eqs. 8-9 threshold update is carried across the ticks where
the row had items, and every tick's row is triaged against that tick's
thresholds.

* ``superstep`` is the wrapper: CUDA tensors launch the hand-written
  kernel ``csrc/superstep.cu`` (one warp per row, thresholds carried in
  registers, ``csrc/triage_row.cuh``'s row triage) and bump ``LAUNCHES``;
  CPU tensors run ``superstep_torch``.  There is no fallback between the
  two: a CUDA tensor the kernel cannot take raises.
* ``superstep_torch`` is the plain PyTorch version: a Python loop over S
  with every f32 operation rounded on its own, as the reference's scan
  does, then ``triage_fleet_torch`` over the S·R folded rows.

Both replace ``repro.system.superstep._superstep_fn``.  Every output —
the f32 thresholds included — must be bit-identical between the two: the
``superstep=1`` vs ``superstep=K`` contract of ``system/superstep.py``
rests on it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.triage import triage_fleet_torch

#: kernel launches made by ``superstep`` (a CPU call never counts)
LAUNCHES = 0


def superstep_torch(conf: torch.Tensor, th0: torch.Tensor,
                    mask: torch.Tensor, drain: torch.Tensor,
                    gains: torch.Tensor, *, capacity: int):
    """conf (S, R, N) f32, th0 (R, 2) f32, mask (S, R) bool/uint8, drain
    (R,) f32, gains (4,) f32 [gamma1, gamma1_up, gamma2, interval_s] ->
    (routes (S, R, N) i32, slots (S, R, N) i32, ths (S, R, 2) f32)."""
    g1, g1u, g2, interval = gains[0], gains[1], gains[2], gains[3]
    gain = torch.where(drain >= interval, g1, g1u)
    pull = gain * (drain - interval)
    mask = mask.to(torch.bool)
    th = th0
    ths = []
    for s in range(conf.shape[0]):
        alpha = torch.clamp(th[:, 0] - pull, 0.5, 1.0)
        new = torch.stack([alpha, g2 * (1.0 - alpha)], dim=-1)
        th = torch.where(mask[s, :, None], new, th)
        ths.append(th)
    ths = torch.stack(ths)
    S, R, N = conf.shape
    routes, slots, _ = triage_fleet_torch(
        conf.reshape(S * R, N), ths.reshape(S * R, 2), capacity=capacity)
    return routes.reshape(S, R, N), slots.reshape(S, R, N), ths


def _check(conf, th0, mask, drain, gains) -> None:
    for name, t in (("conf", conf), ("th0", th0), ("drain", drain),
                    ("gains", gains)):
        if t.dtype != torch.float32:
            raise TypeError(f"superstep takes float32 {name}, got {t.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"superstep takes a bool/uint8 mask, got "
                        f"{mask.dtype}")
    if conf.ndim != 3:
        raise ValueError(f"superstep takes conf (S, R, N), got "
                         f"{tuple(conf.shape)}")
    S, R, _ = conf.shape
    want = {"th0": (R, 2), "mask": (S, R), "drain": (R,), "gains": (4,)}
    for name, t in (("th0", th0), ("mask", mask), ("drain", drain),
                    ("gains", gains)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"superstep: {name} {tuple(t.shape)} does not "
                             f"match conf {tuple(conf.shape)} (want "
                             f"{want[name]})")
    if len({t.device for t in (conf, th0, mask, drain, gains)}) != 1:
        raise ValueError("superstep: inputs lie on different devices")


def superstep(conf: torch.Tensor, th0: torch.Tensor, mask: torch.Tensor,
              drain: torch.Tensor, gains: torch.Tensor, *, capacity: int):
    """One scan superstep on the tensors' device: the CUDA kernel for CUDA
    tensors, ``superstep_torch`` for CPU tensors.  Shapes and outputs as
    ``superstep_torch``."""
    global LAUNCHES
    _check(conf, th0, mask, drain, gains)
    if conf.device.type == "cpu":
        return superstep_torch(conf, th0, mask, drain, gains,
                               capacity=capacity)
    if conf.device.type != "cuda":
        raise ValueError(f"superstep: no kernel for device {conf.device}")
    S, R, N = conf.shape
    if S == 0 or R == 0 or N == 0:
        raise ValueError(f"superstep: empty conf {tuple(conf.shape)}")
    conf, th0, drain, gains = (t.contiguous()
                               for t in (conf, th0, drain, gains))
    mask = mask.to(torch.uint8).contiguous()
    routes = torch.empty((S, R, N), dtype=torch.int32, device=conf.device)
    slots = torch.empty((S, R, N), dtype=torch.int32, device=conf.device)
    ths = torch.empty((S, R, 2), dtype=torch.float32, device=conf.device)
    rc = runtime.library("superstep").superstep_launch(
        conf.data_ptr(), th0.data_ptr(), mask.data_ptr(), drain.data_ptr(),
        gains.data_ptr(), routes.data_ptr(), slots.data_ptr(),
        ths.data_ptr(), S, R, N, int(capacity), runtime.stream(conf.device))
    runtime.check_launch("superstep", rc)
    LAUNCHES += 1
    return routes, slots, ths
