"""LR schedules as step -> lr functions (port of
:mod:`repro.optim.schedules`): the step is a 0-d int32 tensor, the rate a
0-d float32 tensor on its device, computed there with no read on the
host."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    def fn(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return fn


def cosine_with_warmup(peak: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)

    return fn
