"""LR schedule: a pure function of the integer step, returning a float.
Only ``cosine_warmup`` (the CLI's) is ported."""
from __future__ import annotations

import math


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step: int) -> float:
        if step < warmup:
            return lr * min(1.0, step / max(warmup, 1))
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return fn
