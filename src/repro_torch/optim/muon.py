"""Muon (Jordan et al., 2024): orthogonalized momentum by Newton–Schulz —
plus the subspace-fused variant. The counterpart of ``repro/optim/muon.py``.

``rank=None`` (the default) is the full-space baseline: NS on the full
(m, n) moment. ``rank=r`` projects the nesterov-adjusted moment into the
dynamically selected DCT subspace by the one-pass select+project
(``core/fused_step.py``), runs Newton–Schulz on the (rows, r) low-rank
factor — r-sized Gram matrices instead of n-sized — and back-projects
through the gathered ``Q_r^T`` (``colgather_matmul`` on the kernel path). At
full rank (r = min(m, n)) this matches the full-space update up to NS's
polynomial tolerance, because NS commutes with right-multiplication by an
orthogonal matrix: ``NS(X Q) = NS(X) Q`` in exact arithmetic.

Momentum is stored *oriented* (projected dim last). Full-space NS on a
moment whose short side exceeds ``fused_step.NS_KERNEL_MAX_RANK`` runs the
plain iteration even on the "on" path (llama-350m's: 1024).

Telemetry (``emit_stats``, with a collector installed): the subspace
variant records the captured energy and top-r margin of its selection from
the column norms of S; it keeps no EF (``ef_norm`` 0) and no indices
(overlap -1). Full-space Muon selects nothing and records nothing.

ZeRO-1 (``zero=``, ``repro_torch.parallel.zero``): the rule is
``zero_shardable``. On a row block the subspace variant completes its
column statistic across the shards and all-gathers the rank-sized factor
for Newton–Schulz (full-space NS all-gathers the moment); every rank keeps
its own rows of the result.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import fused_step
from repro_torch.core.selection import (allsum, column_norms, select_top_r,
                                        take_columns, topr_margin)
from repro_torch.telemetry import stats as tstats

from .common import (
    MatrixRule,
    Optimizer,
    Schedule,
    deorient,
    orient_right,
    oriented_dims,
)
from .transform import (
    GradientTransform,
    add_decayed_weights,
    chain,
    lowrank_project,
    matrix_optimizer,
    scale_by_learning_rate,
)

_RANKING_NORMS = ("l1", "l2")


class MuonLeaf(NamedTuple):
    m: torch.Tensor  # momentum, stored oriented (projected dim last)


@dataclasses.dataclass(frozen=True)
class MuonRule(MatrixRule):
    rank: int | None = None          # None = full-space NS
    mu: float = 0.95
    ns_steps: int = 5
    nesterov: bool = True
    ranking_norm: str = "l2"
    needs_shared_basis: bool = True  # basis_sizes() is () when rank is None
    fused: str = "auto"              # "auto" | "on" | "fft" | "off"
    emit_stats: bool = True          # SubspaceStats into ctx.stats

    def __post_init__(self):
        if self.ranking_norm not in _RANKING_NORMS:
            raise ValueError(f"unknown ranking_norm {self.ranking_norm!r}; "
                             f"allowed: {_RANKING_NORMS}")
        if self.fused not in fused_step.FUSED_MODES:
            raise ValueError(f"unknown fused mode {self.fused!r}; allowed: "
                             f"{fused_step.FUSED_MODES}")
        if self.rank is not None and self.rank < 1:
            raise ValueError(f"rank must be >= 1 or None, got {self.rank}")

    @property
    def zero_shardable(self) -> bool:
        """Row-parallel given the cross-shard column statistic and the
        gathered factor (module docstring)."""
        return True

    def basis_sizes(self, shape) -> tuple:
        return () if self.rank is None else (oriented_dims(shape)[1],)

    def init(self, shape, dtype, device=None):
        *batch, _, _ = shape
        rows, cols = oriented_dims(shape)
        return MuonLeaf(m=torch.zeros((*batch, rows, cols),
                                      dtype=torch.float32, device=device))

    def update(self, g, state: MuonLeaf, param, ctx):
        if ctx.oriented:        # a ZeRO row block: right-oriented already
            gf, transposed = g.float(), False
        else:
            gf, transposed = orient_right(g.float())
        new_m = (self.mu * state.m + gf).contiguous()
        ns_in = (gf + self.mu * new_m if self.nesterov else new_m).contiguous()
        # Muon's shape-aware step scale from the whole leaf's shape (a ZeRO
        # row block's aspect ratio differs)
        rows, cols = sorted(param.shape[-2:], reverse=True)
        scale = max(1.0, (rows / cols) ** 0.5)
        mode = fused_step.resolve(self.fused, gf.device)

        if self.rank is None:
            o = fused_step.fused_newton_schulz(ns_in, steps=self.ns_steps,
                                               mode=mode,
                                               gather_axes=ctx.axis)
            return scale * deorient(o, transposed), MuonLeaf(m=new_m)

        n = ns_in.shape[-1]
        r = min(self.rank, n)
        q = ctx.basis(n, torch.float32, device=gf.device)
        want_stats = ctx.wants_stats and self.emit_stats
        if mode != "off":
            sp = fused_step.select_and_project(
                ns_in, q, r, norm=self.ranking_norm, mode=mode,
                return_norms=want_stats, psum_axes=ctx.axis)
            idx, b_low = sp[0], sp[1]
            norms_sq = sp[2] if want_stats else None
        else:
            s = ns_in @ q
            norms_sq = (allsum(column_norms(s, "l2"), ctx.axis)
                        if want_stats or self.ranking_norm == "l2" else None)
            rank_norms = (norms_sq if self.ranking_norm == "l2"
                          else allsum(column_norms(s, self.ranking_norm),
                                      ctx.axis))
            idx = select_top_r(rank_norms, r)
            b_low = take_columns(s, idx)
        if want_stats:
            col_e = torch.gather(norms_sq, -1, idx.long())
            sel_sq = col_e.sum(dim=-1)
            batch = ns_in.shape[:-2]
            ctx.record_stats(tstats.SubspaceStats(
                captured_energy=tstats.captured_energy(
                    sel_sq, norms_sq.sum(dim=-1)),
                topr_margin=topr_margin(norms_sq, r),
                index_overlap=tstats.sentinel(batch, ns_in.device),
                ef_norm=torch.zeros(batch, dtype=torch.float32,
                                    device=ns_in.device),
                rank_utilization=tstats.rank_utilization(col_e)))
        o = fused_step.fused_newton_schulz(b_low, steps=self.ns_steps,
                                           mode=mode, gather_axes=ctx.axis)
        d = fused_step.fused_backproject(o, q, idx, mode=mode,
                                         qt=ctx.basis_t(n))
        return scale * deorient(d, transposed), MuonLeaf(m=new_m)


def muon_transform(lr: Schedule, *, rank: int | None = None, mu: float = 0.95,
                   weight_decay: float = 0.01, ns_steps: int = 5,
                   nesterov: bool = True, ranking_norm: str = "l2",
                   fused: str = "auto") -> GradientTransform:
    """Matrix-leaf Muon pipeline (orthogonalize -> -lr -> decay) for
    ``partition``."""
    rule = MuonRule(rank=rank, mu=mu, ns_steps=ns_steps, nesterov=nesterov,
                    ranking_norm=ranking_norm, fused=fused)
    return chain(lowrank_project(rule), scale_by_learning_rate(lr),
                 add_decayed_weights(weight_decay, schedule=lr))


def muon(lr: Schedule, *, rank: int | None = None, mu: float = 0.95,
         weight_decay: float = 0.01, ns_steps: int = 5, nesterov: bool = True,
         ranking_norm: str = "l2", fused: str = "auto",
         basis_mode: str = "stored", b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, label_fn=None, zero=None,
         lr_scale: bool = False) -> Optimizer:
    """Muon on the matrix leaves (full space, or the rank-r subspace),
    full-rank Adam on the rest. ``zero``: a ``parallel.zero.ZeroConfig``
    (ZeRO-1 on the active mesh)."""
    rule = MuonRule(rank=rank, mu=mu, ns_steps=ns_steps, nesterov=nesterov,
                    ranking_norm=ranking_norm, fused=fused)
    kw = dict(weight_decay=weight_decay, basis_mode=basis_mode, b1=b1, b2=b2,
              eps=eps, zero=zero, lr_scale=lr_scale)
    if label_fn is not None:
        kw["label_fn"] = label_fn
    return matrix_optimizer(rule, lr, **kw)
