"""Learning-rate schedules (port of genrec_tpu/ops/schedules.py): step ->
learning rate callables, evaluated in float32 as the JAX ones are. The
optimizer (``core/optim.py``) evaluates them at the update count before
its increment, as optax does."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_schedule_with_warmup(base_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup 0 -> base, then linear decay base -> 0 at total_steps."""

    def schedule(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        decay = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return base_lr * torch.clamp(torch.where(step < warmup_steps, warm, decay), 0.0, 1.0)

    return schedule


def cosine_schedule_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                                num_cycles: float = 0.5):
    """Linear warmup then cosine decay to 0 (HF semantics, num_cycles=0.5)."""

    def schedule(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * torch.where(step < warmup_steps, torch.clamp(warm, 0.0, 1.0),
                                     torch.clamp(cos, min=0.0))

    return schedule


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int):
    """Constant during warmup, then base * sqrt(warmup / step)."""

    def schedule(step):
        step = _f32(step) + 1.0
        scale = torch.sqrt(warmup_steps / torch.clamp(step, min=1.0))
        return base_lr * torch.where(step <= warmup_steps, 1.0, scale)

    return schedule
