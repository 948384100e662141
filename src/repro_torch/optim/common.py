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

The monolithic ``make_matrix_optimizer`` harness at the bottom is the
legacy reference implementation, as in the JAX package: the live presets
are the transform chains of :mod:`repro_torch.optim.transform`, and the
harness is kept so the tests can pin the chains against it bit for bit.

``path_str`` (the JAX package's join of a pytree key path) is not ported:
the port's trees are flat dicts already keyed by the string it returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.transforms import (
    basis_store_key,
    get_backend,
    normalize_basis_request,
    shared_basis,
)

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


class HarnessState(NamedTuple):
    """State of the legacy harness: the global step, the root key (the
    ``seed``, as the port's ``ChainState`` holds it), the shared bases
    with their contiguous transposes (as in ``ChainState``) and the flat
    ``{path: leaf state}`` leaves."""

    step: int
    key: int
    bases: dict
    leaves: dict
    bases_t: dict


def make_matrix_optimizer(
    rule: MatrixRule,
    lr: Schedule,
    *,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    label_fn=default_label_fn,
    basis_mode: str = "stored",   # "stored" (paper) | "onthefly"
    seed: int = 0,
    fullrank_weight_decay: bool = True,
) -> Optimizer:
    """Wrap a MatrixRule into a full-model optimizer with an AdamW
    fallback for the ``"full"`` leaves: the legacy reference harness. The
    live presets are the equivalent chains of
    ``transform.matrix_optimizer``; the tests pin the two bit for bit."""
    # the chain runtime's key stream and basis store, one module up
    from .transform import fold_in, leaf_key, transposed

    def init(params):
        labels = labelled_tree(params, label_fn)
        sizes = set()
        if rule.needs_shared_basis and basis_mode == "stored":
            for path, p in params.items():
                if labels[path] == "lowrank":
                    sizes.update(normalize_basis_request(s)
                                 for s in rule.basis_sizes(p.shape))
        device = next(iter(params.values())).device if params else None
        bases = {basis_store_key(k, n): shared_basis(k, n, torch.float32,
                                                     device)
                 for k, n in sorted(sizes)}
        leaves = {}
        for path, p in params.items():
            if labels[path] == "lowrank":
                leaves[path] = rule.init(p.shape, p.dtype, p.device)
            else:
                leaves[path] = FullAdamLeaf(AdamMoments(
                    torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)))
        return HarnessState(step=0, key=seed, bases=bases, leaves=leaves,
                            bases_t=transposed(bases))

    def update(grads, state: HarnessState, params):
        step = state.step + 1
        lr_t = sched_value(lr, step)
        labels = labelled_tree(params, label_fn)
        key = fold_in(state.key, step)
        updates, leaves = {}, {}
        for path, g in grads.items():
            s, p = state.leaves[path], params[path]
            if labels[path] == "lowrank":
                # per-leaf key: a stable hash of the path, not the order of
                # the leaves
                ctx = Context(step=step, bases=state.bases,
                              bases_t=state.bases_t, key=leaf_key(key, path))
                d, leaves[path] = rule.update(g, s, p, ctx)
                upd = -lr_t * d.float()
                updates[path] = upd - lr_t * weight_decay * p.float()
                continue
            direction, mom = adam_update(g, s.mom, step, b1, b2, eps)
            upd = -lr_t * direction
            if fullrank_weight_decay:
                upd = upd - lr_t * weight_decay * p.float()
            updates[path], leaves[path] = upd, FullAdamLeaf(mom)
        return updates, state._replace(step=step, leaves=leaves)

    return Optimizer(init=init, update=update)
