"""LR schedules (warmup + cosine, the production default) — the port of
``repro.optim.schedule``.  A schedule maps the step (an int or a tensor)
to the learning rate as a float32 0-d tensor on the step's device."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return f
