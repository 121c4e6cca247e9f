"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro/optim/schedules.py``: ``step`` is a tensor, the result a
float32 tensor on its device.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return final_frac + (1 - final_frac) * cos


def linear_warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    warm = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step.float() - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
