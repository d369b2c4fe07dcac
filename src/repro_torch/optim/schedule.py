"""Learning-rate schedules (``repro/optim/schedule.py``): callables from a
step count (an int or an integer tensor) to a float32 0-d tensor, in the
reference's op order."""

from __future__ import annotations

import math

import torch


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as a true division (the card computes a division by a
    Python number as a product with its reciprocal)."""
    return x / torch.tensor(float(n), device=x.device)


def constant_schedule(value: float):
    def schedule(count):
        return torch.tensor(value, dtype=torch.float32) + 0.0 * _f32(count)
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    def schedule(count):
        frac = torch.clamp(_div(_f32(count), max(1, transition_steps)),
                           0.0, 1.0)
        return init_value + frac * (end_value - init_value)
    return schedule


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, end_lr_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``end_lr_frac * peak_lr``."""
    def schedule(count):
        t = _f32(count)
        warm = _div(peak_lr * t, max(1, warmup_steps))
        frac = torch.clamp(_div(t - warmup_steps,
                                max(1, total_steps - warmup_steps)), 0.0, 1.0)
        cos = peak_lr * (end_lr_frac + (1 - end_lr_frac) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(t < warmup_steps, warm, cos)
    return schedule
