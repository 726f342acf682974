"""Learning-rate schedules as functions of the step counter (an int or a
0-dim tensor), computed in fp32 as ``repro/optim/schedules.py`` computes
them; each returns a 0-dim fp32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _frac(step: torch.Tensor, warmup_steps: int, total_steps: int):
    return torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def _warm(step: torch.Tensor, peak_lr: float, warmup_steps: int):
    return peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``."""
    s = _step_f32(step)
    frac = _frac(s, warmup_steps, total_steps)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup_steps, _warm(s, peak_lr, warmup_steps),
                       peak_lr * cos)


def warmup_linear(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then linear decay to 0."""
    s = _step_f32(step)
    frac = _frac(s, warmup_steps, total_steps)
    return torch.where(s < warmup_steps, _warm(s, peak_lr, warmup_steps),
                       peak_lr * (1 - frac))
