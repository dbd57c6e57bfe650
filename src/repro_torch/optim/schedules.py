"""Learning-rate schedules (port of ``repro.optim.schedules``): plain
functions of an integer step that return a float."""
from __future__ import annotations

import math
from typing import Callable


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    def fn(step: int) -> float:
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> Callable[[int], float]:
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def fn(step: int) -> float:
        if step <= warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)
    return fn
