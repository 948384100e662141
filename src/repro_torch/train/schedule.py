"""LR schedules: pure functions of the integer step, returning a float (the
JAX package's return an fp32 scalar; these compute in float64, and the
update rounds the value to fp32 where it multiplies)."""
from __future__ import annotations

import math


def constant(lr: float):
    def fn(step: int) -> float:
        return float(lr)
    return fn


def linear_warmup(lr: float, warmup: int):
    def fn(step: int) -> float:
        return lr * min(1.0, step / max(warmup, 1))
    return fn


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step: int) -> float:
        if step < warmup:
            return lr * min(1.0, step / max(warmup, 1))
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return fn
