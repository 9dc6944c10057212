"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step.  The step may be a Python int or a 0-d tensor on
any device; the lr comes back as a 0-d f32 tensor on the step's device, so
reading it inside a train step costs no host synchronization."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(step, *, peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0) -> torch.Tensor:
    step = _step_f32(step)
    warm = peak * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_linear(step, *, peak: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    step = _step_f32(step)
    warm = peak * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    lin = peak * (1.0 - torch.clamp(t, 0.0, 1.0))
    return torch.where(step < warmup_steps, warm, lin)
