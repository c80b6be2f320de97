"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warm-up to ``peak``, then a cosine down to ``floor * peak``.

    The returned function takes a 0-d integer step tensor and gives a 0-d
    f32 tensor on the step's device (no host sync)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr
