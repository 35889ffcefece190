"""LR schedule: linear warmup into cosine or polynomial decay (port of
minddiffusion_tpu/train/lr_schedules.py).

During warmup lr ramps linearly 0 -> start_lr; afterwards it decays
start_lr -> end_lr over `decay_steps`, by cosine (default) or
polynomial(power). The schedule is read at the optimizer's update count,
which starts at 0, so with warmup_steps > 0 the first update has lr 0 (as
optax reads it). It takes an int or a 0-d tensor, so the step can stay on
the device, and computes in fp32 like the JAX schedule.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch


def warmup_then_decay(start_lr: float, end_lr: float, warmup_steps: int,
                      decay_steps: int, power: float = 1.0,
                      use_cosine: bool = True) -> Callable:
    """Returns schedule(step) -> lr, a 0-d fp32 tensor on step's device."""

    def schedule(step: Union[int, torch.Tensor]) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        frac = torch.clamp(step / max(1.0, float(decay_steps)), 0.0, 1.0)
        if use_cosine:
            decayed = end_lr + 0.5 * (start_lr - end_lr) * (1 + torch.cos(math.pi * frac))
        else:
            decayed = (start_lr - end_lr) * (1 - frac) ** power + end_lr
        if warmup_steps > 0:
            warm = start_lr * step / float(warmup_steps)
            return torch.where(step < warmup_steps, warm, decayed)
        return decayed

    return schedule
