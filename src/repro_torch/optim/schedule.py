"""LR schedules: linear warmup + cosine (or linear) decay, the
reference's ``optim/schedule.py``. The step is a host integer."""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 5e-4
    warmup_steps: int = 100
    total_steps: int = 2000
    final_fraction: float = 0.1
    kind: str = "cosine"  # cosine | linear | constant


def make_schedule(cfg: ScheduleConfig):
    def schedule(step: int) -> float:
        # 1-indexed so the first optimizer step gets a nonzero LR
        step = float(step) + 1.0
        warm = cfg.peak_lr * min(step / max(cfg.warmup_steps, 1), 1.0)
        if cfg.kind == "constant":
            lr = warm
        else:
            frac = min(max((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
            if cfg.kind == "cosine":
                decay = cfg.final_fraction + (1 - cfg.final_fraction) * 0.5 * (
                    1 + math.cos(math.pi * frac))
            else:
                decay = 1.0 - (1 - cfg.final_fraction) * frac
            lr = warm if step < cfg.warmup_steps else cfg.peak_lr * decay
        # the reference evaluates the schedule in fp32
        return float(np.float32(lr))

    return schedule
