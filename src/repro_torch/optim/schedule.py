"""Learning-rate schedules: functions of the step (PyTorch counterpart of
``repro.optim.schedule``).  The step may be a host int or a 0-d tensor on
the device (``OptState.step``); the rate is a 0-d fp32 tensor on the
step's device, computed there, so a train step reads nothing back."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_linear"]


def _warm_and_t(base_lr, warmup_steps, total_steps, step):
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return step, warm, t


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step, warm, t = _warm_and_t(base_lr, warmup_steps, total_steps, step)
        cos = base_lr * (min_ratio + (1 - min_ratio) *
                         0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int):
    def lr(step):
        step, warm, t = _warm_and_t(base_lr, warmup_steps, total_steps, step)
        return torch.where(step < warmup_steps, warm, base_lr * (1 - t))

    return lr
