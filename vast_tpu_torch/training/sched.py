"""LR schedules as ratios of the peak LR (reference utils/sched.py).

The port's own copy of ``vast_tpu.training.sched`` (sched.py:8-37).
"""

from __future__ import annotations

import math


def warmup_linear(x: float, warmup_ratio: float) -> float:
    if x < warmup_ratio:
        return x / warmup_ratio
    return max((x - 1.0) / (warmup_ratio - 1.0), 0.0)


def warmup_cosine(x: float, warmup_ratio: float) -> float:
    if x < warmup_ratio:
        return x / warmup_ratio
    return 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup_ratio: float) -> float:
    if x < warmup_ratio:
        return x / warmup_ratio
    return 1.0


SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
}


def get_lr_ratio(global_step: int, num_train_steps: int, scheduler: str,
                 warmup_ratio: float) -> float:
    """Ratio of peak LR at ``global_step`` (utils/sched.py:22-31)."""
    x = global_step / max(num_train_steps, 1)
    return SCHEDULES[scheduler](x, warmup_ratio)
