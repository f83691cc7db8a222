"""Learning-rate schedules, pure functions of the step counter
(``repro.optim.schedules``); each returns a float32 scalar tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * lr`` at ``total_steps``."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(step < warmup_steps, warm, lr * cos)
    return sched
