"""Optimizer registry — ``get_optimizer(name, lr, **kw)``.

Ported: the paper's ``dct_adamw`` and the momentum families ``trion`` (the
JAX CLI's default), ``muon`` and ``dion``. The other presets of
``repro.optim.api`` raise "not yet ported".
"""
from __future__ import annotations

import inspect

from .common import Optimizer, Schedule
from .dion import dion, dion_transform
from .muon import muon, muon_transform
from .projected_adam import dct_adamw, dct_adamw_transform
from .trion import trion, trion_transform

OPTIMIZERS = {"dct_adamw": dct_adamw, "trion": trion, "muon": muon,
              "dion": dion}
TRANSFORMS = {"dct_adamw": dct_adamw_transform, "trion": trion_transform,
              "muon": muon_transform, "dion": dion_transform}

#: presets of the JAX registry this package does not build yet
NOT_YET_PORTED = ("adamw", "ldadamw", "galore", "frugal", "fira")


def _lookup(table: dict, name: str):
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not yet ported to "
                                  f"repro_torch; have {sorted(table)}")
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
