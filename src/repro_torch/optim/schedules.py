"""Learning-rate schedules as functions of the optimizer's step count
(port of ``repro.optim.schedules``): they take the count tensor and return
an f32 tensor on its device, so no value leaves the card."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return f


def wsd(peak_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.2):
    """Warmup–stable–decay."""
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        dec = peak_lr * (1 - prog)
        out = torch.where(step < warmup_steps, warm,
                          torch.full_like(step, peak_lr))
        return torch.where(step > decay_start, dec, out)

    return f
