"""Full-rank AdamW — the paper's reference optimizer, as a transform chain.

``adamw_transform`` is the composable building block (usable inside
``partition`` or ``inject_hyperparams``); ``adamw`` closes it into
``Optimizer(init, update)``, with the resilience ladder's ``lr_scale`` seam
on request.
"""
from __future__ import annotations

from .common import Optimizer, Schedule
from .transform import (
    GradientTransform,
    add_decayed_weights,
    as_optimizer,
    chain,
    scale_by_adam,
    scale_by_learning_rate,
)


def adamw_transform(lr: Schedule, *, weight_decay: float = 0.01,
                    b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransform:
    """Adam direction -> -lr scaling -> decoupled weight decay."""
    return chain(
        scale_by_adam(b1, b2, eps),
        scale_by_learning_rate(lr),
        add_decayed_weights(weight_decay, schedule=lr),
    )


def adamw(lr: Schedule, *, weight_decay: float = 0.01, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          lr_scale: bool = False) -> Optimizer:
    return as_optimizer(adamw_transform(lr, weight_decay=weight_decay,
                                        b1=b1, b2=b2, eps=eps),
                        lr_scale=lr_scale)
