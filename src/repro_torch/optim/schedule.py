"""Learning-rate schedules — the port of ``repro.optim.schedule``.

A schedule maps the optimizer step (a Python int) to the learning rate as
a 0-d float32 CPU tensor, computed in float32 as the reference computes
it."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup_cosine(peak: float, warmup: int, total: int,
                         floor: float = 0.0):
    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return sched
