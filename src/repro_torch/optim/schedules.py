"""LR schedules: pure functions of the step counter, a tensor on the
training device (the twin of ``repro/optim/schedules.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant", "warmup_linear"]


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak_lr * s / max(1, warmup_steps)
        prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak_lr * s / max(1, warmup_steps)
        lin = peak_lr * torch.clamp(
            1.0 - (s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        return torch.where(s < warmup_steps, warm, lin)

    return fn
