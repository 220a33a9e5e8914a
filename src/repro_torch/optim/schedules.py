"""Learning-rate schedules: callables of the step count.

Port of ``repro/optim/schedules.py``.  A schedule takes the step as a 0-d
integer tensor (or an int) and returns a 0-d float32 tensor on the step's
device, with the reference's float32 arithmetic in its order, so the
optimizer reads it without a host sync.
"""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def sched(step):
        s = _steps(step)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return sched


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    def sched(step):
        s = _steps(step)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, peak * cos)
    return sched
