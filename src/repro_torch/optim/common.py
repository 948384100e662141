"""Shared optimizer framework.

``Optimizer(init, update)`` pairs plus the shared vocabulary of the
optimizer layer: leaf routing (``default_label_fn``), matrix orientation,
Adam moments, the per-leaf :class:`MatrixRule` protocol and the
:class:`Context` that carries the step, the key and the shared bases.

Parameter, gradient and state trees are flat dicts keyed by the JAX tree's
leaf path (``"segments/0/p0/attn/wq/kernel"``), so ``default_label_fn`` routes
leaves by exactly the names the JAX package sees. Matrix leaves may carry
leading stacked axes ``(layers, m, n)``; every rule broadcasts over them,
which is how per-layer column indices of shape ``(layers, r)`` fall out.

The step is a host integer: the branches that depend on it (refresh every
``update_interval`` steps, bias correction) are Python branches.

The legacy ``make_matrix_optimizer`` harness of the JAX package is not
ported; the transform chains of :mod:`repro_torch.optim.transform` are the
live presets there too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.transforms import basis_store_key, get_backend

Schedule = Callable[[int], float] | float


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]  # (grads, state, params)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """New parameters ``p + u`` (new tensors: nothing is updated in place)."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def reject_unported(*, zero=None) -> None:
    """Raise on the preset option of the JAX package the port does not have
    yet: ZeRO-1 sharding."""
    if zero is not None:
        raise NotImplementedError("zero= (ZeRO-1 sharding) is not yet ported "
                                  "to repro_torch")


def sched_value(lr: Schedule, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


# ---------------------------------------------------------------------------
# Leaf routing
# ---------------------------------------------------------------------------
_FULLRANK_NAME_HINTS = ("embed", "unembed", "lm_head", "vocab", "norm", "scale",
                        "bias", "pos_emb", "a_log", "dt", "decay", "conv")


def default_label_fn(path: str, leaf) -> str:
    """'lowrank' for linear-layer matrices, 'full' otherwise (paper practice)."""
    lname = path.lower()
    if any(h in lname for h in _FULLRANK_NAME_HINTS):
        return "full"
    if leaf.ndim >= 2 and min(leaf.shape[-2:]) >= 8:
        return "lowrank"
    return "full"


def labelled_tree(params: dict, label_fn=default_label_fn) -> dict[str, str]:
    return {path: label_fn(path, p) for path, p in params.items()}


# ---------------------------------------------------------------------------
# Matrix orientation: rules are written for *right* projection of (…, m, n)
# with n = min(m, n) (paper: "compress the smallest dimension").
# ---------------------------------------------------------------------------
def orient_right(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``x`` or its transpose, whichever has the smaller dim last. The
    transpose is a *view*: call ``.contiguous()`` before a kernel reads it."""
    m, n = x.shape[-2], x.shape[-1]
    if n <= m:
        return x, False
    return x.transpose(-1, -2), True


def deorient(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Undo ``orient_right``; a transposed result is made contiguous so the
    updates (and the parameters they produce) keep the parameter layout."""
    return x.transpose(-1, -2).contiguous() if transposed else x


def oriented_dims(shape) -> tuple[int, int]:
    m, n = shape[-2], shape[-1]
    return (m, n) if n <= m else (n, m)


# ---------------------------------------------------------------------------
# Adam moments (used by every Adam-family rule)
# ---------------------------------------------------------------------------
class AdamMoments(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam_update(g, mom: AdamMoments, step: int, b1, b2, eps
                ) -> tuple[torch.Tensor, AdamMoments]:
    gf = g.float()
    m = b1 * mom.m + (1.0 - b1) * gf
    v = b2 * mom.v + (1.0 - b2) * gf * gf
    t = float(step)
    mhat = m / (1.0 - b1**t)
    vhat = v / (1.0 - b2**t)
    return mhat / (torch.sqrt(vhat) + eps), AdamMoments(m, v)


# ---------------------------------------------------------------------------
# Per-leaf rules
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MatrixRule:
    """Per-matrix-leaf rule. ``ctx`` carries the step and the shared bases."""

    def init(self, shape, dtype, device=None) -> Any:
        raise NotImplementedError

    def update(self, g, state, param, ctx) -> tuple[torch.Tensor, Any]:
        """Returns (descent direction D, new state). The chain applies
        ``-lr * D - lr * wd * p``."""
        raise NotImplementedError

    def basis_sizes(self, shape) -> tuple:
        """Which shared bases this leaf needs: ``(kind, n)`` pairs, or bare
        orders ``n`` (the DCT basis). Default: DCT at the min oriented dim."""
        return (oriented_dims(shape)[1],)

    needs_shared_basis: bool = False


class FullAdamLeaf(NamedTuple):
    mom: AdamMoments


@dataclasses.dataclass(frozen=True)
class Context:
    step: int
    # shared predefined bases keyed by ``transforms.basis_store_key`` (bare
    # "n" for DCT); may be empty (on-the-fly mode)
    bases: dict
    # contiguous transposes of ``bases``, same keys: the back-projection
    # kernel reads rows of Q^T from memory, and ``q.T`` is only a view
    bases_t: dict = dataclasses.field(default_factory=dict)
    # the step's key in the chain runtime, the leaf's inside
    # ``lowrank_project`` (``transform.leaf_key``): the random projectors'
    # draws are seeded from it
    key: int | None = None
    # telemetry channel (``repro_torch.telemetry.stats``): the chain runtime
    # installs the active StatsCollector here and ``lowrank_project``
    # narrows it to a per-leaf StatsScope. None = telemetry off: the rules
    # then build no stat, and the step launches what it launches without
    # telemetry.
    stats: Any = None

    def record_stats(self, stats) -> None:
        """Emit this leaf's SubspaceStats into the active collector (no-op
        when telemetry is off)."""
        if self.stats is not None:
            self.stats.record(stats)

    @property
    def wants_stats(self) -> bool:
        return self.stats is not None

    def basis(self, n: int, dtype=torch.float32, kind: str = "dct",
              device=None) -> torch.Tensor:
        """The shared ``(n, n)`` basis of ``kind`` — from the stored bases
        when the runtime collected it, else rebuilt by the backend."""
        key = basis_store_key(kind, n)
        if self.bases and key in self.bases:
            return self.bases[key].to(dtype)
        return get_backend(kind).matrix(n, dtype, device)

    def basis_t(self, n: int, kind: str = "dct") -> torch.Tensor | None:
        """The cached contiguous ``Q^T``, or None when none is stored."""
        return self.bases_t.get(basis_store_key(kind, n))
