"""Learning-rate schedules (pure functions of the step) — port of
``repro.optim.schedule``.  ``step`` is an int tensor or a Python int; the
result is a float32 0-d tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    t = torch.clamp(_f32(step) / max(1, total_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1):
    step_f = _f32(step)
    warm = step_f / max(1, warmup_steps)
    after = cosine_schedule(torch.as_tensor(step) - warmup_steps, base_lr=base_lr,
                            total_steps=max(1, total_steps - warmup_steps),
                            final_frac=final_frac)
    return torch.where(step_f < warmup_steps, base_lr * warm, after)
