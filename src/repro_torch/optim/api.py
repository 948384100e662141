"""Optimizer registry — ``get_optimizer(name, lr, **kw)``.

The nine presets of ``repro.optim.api``: the paper's ``dct_adamw``, its
baselines ``ldadamw``, ``galore``, ``frugal``, ``fira`` and the full-rank
``adamw``, and the momentum families ``trion`` (the JAX CLI's default),
``muon`` and ``dion``. ``TRANSFORMS`` holds the transform-level factories
for composition. ``galore`` / ``frugal`` / ``fira`` take ``projector=``: a
dense kind (svd, random, randperm) or a registered basis backend
(dct/dst/hadamard/randortho), which runs the fused dataflow.
"""
from __future__ import annotations

import inspect

from .adamw import adamw, adamw_transform
from .common import Optimizer, Schedule
from .dion import dion, dion_transform
from .muon import muon, muon_transform
from .projected_adam import (
    dct_adamw,
    dct_adamw_transform,
    fira,
    frugal,
    galore,
    ldadamw,
)
from .trion import trion, trion_transform

OPTIMIZERS = {"adamw": adamw, "muon": muon, "dion": dion, "trion": trion,
              "dct_adamw": dct_adamw, "ldadamw": ldadamw, "galore": galore,
              "frugal": frugal, "fira": fira}
TRANSFORMS = {"adamw": adamw_transform, "muon": muon_transform,
              "dion": dion_transform, "trion": trion_transform,
              "dct_adamw": dct_adamw_transform}


def _lookup(table: dict, name: str):
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(table)}")
    return table[name]


def _validate_kwargs(name: str, fn, kw: dict) -> None:
    """Reject unknown kwargs eagerly with the allowed set in the message."""
    allowed = sorted(p for p in inspect.signature(fn).parameters if p != "lr")
    unknown = sorted(set(kw) - set(allowed))
    if unknown:
        raise TypeError(f"{name!r} got unknown kwargs {unknown}; "
                        f"allowed: {allowed}")


def get_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    fn = _lookup(OPTIMIZERS, name)
    _validate_kwargs(name, fn, kw)
    return fn(lr, **kw)


def get_transform(name: str, lr: Schedule, **kw):
    """Transform-level counterpart of ``get_optimizer`` for composition."""
    fn = _lookup(TRANSFORMS, name)
    _validate_kwargs(name, fn, kw)
    return fn(lr, **kw)
