"""LR schedules as step -> lr functions (the port of
``src/repro/optim/schedule.py``).  ``step`` is an int32 scalar tensor, as
the optimizer state holds it; the lr is a float32 scalar on its device."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + torch.cos(math.pi * t)))
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(step - warmup))
    return lr
