"""Learning-rate schedules (multipliers in [0,1]; compose with AdamWConfig.lr).

Each schedule maps a step count tensor to an f32 multiplier tensor on the
step's device, as the reference's do."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(warmup_steps: int, total_steps: int, floor: float = 0.1):
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return sched


def linear_warmup(warmup_steps: int):
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        return torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return sched
