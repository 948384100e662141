"""Trion (paper Algorithm 1): Dion with the power iteration / QR replaced by
DCT dynamic column selection, and Newton–Schulz run on the *low-rank*
momentum factor. The counterpart of ``repro/optim/trion.py``.

Per 2D leaf (oriented so the projected dim is last, size C <= R):
    B_t = M_{t-1} + G_t
    S_t = B_t @ D_C                      (DCT-II similarity; matmul or Makhoul)
    i_t = top-r columns of S_t by l1/l2 norm
    b_t = S_t[:, i_t]                    (low-rank momentum, free extraction)
    M_t = B_t - (1-mu) * b_t Q_t^T       (error feedback)
    o_t = NewtonSchulz(b_t)              (r-sized Gram matrices)
    O_t = o_t Q_t^T
    theta <- (1 - lr*wd) theta - lr * max(1, sqrt(R/C)) * O_t

State per leaf: the momentum M, stored *oriented* (projected dim last); the
indices are recomputed every step and never stored.

Dispatch (``fused``, see :mod:`repro_torch.core.fused_step`): "on" (the CUDA
kernels; "auto" on the card) runs ``dct_project`` for S and the column
norms, the Newton–Schulz kernels on the (rows, r) factor, and both
back-projections — the EF reconstruction ``b_t Q_t^T`` and the update
``o_t Q_t^T`` — through one shared ``Q_r^T`` gather
(``colgather_matmul_dual``). "fft" is the same dataflow in plain PyTorch with
S from Makhoul's FFT; "off" is the reference path (``dct_method="fft"``
computes its S by Makhoul too).

The top-r selection is a tie attractor: the error feedback damps every
selected column by (1-mu) while its unselected neighbour keeps its energy,
so the top-r margin shrinks step by step until a 1-ulp difference in S flips
it. Over many steps two implementations that sum in different orders may
therefore select differently; one step from the same state selects alike.

Telemetry (``emit_stats``, with a collector installed): the stats come
from the column norms of S (``dct_project``'s own on the kernel path): the
captured energy of the selected columns, the top-r margin, and the EF mass
``sqrt(||B||^2 - ||b||^2)``; the indices are recomputed every step, so the
overlap is the -1 sentinel.

ZeRO-1 (``zero=``, ``repro_torch.parallel.zero``): the rule is
``zero_shardable`` by gather - compute - slice. A rank all-gathers the
momentum sum of its row block, runs the whole-matrix step on it as the
replicated step does, and keeps its rows of M_t and O_t: the same bits as
the replicated update.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import fused_step
from repro_torch.core.dct import makhoul_dct2
from repro_torch.core.selection import (allgather_rows, column_norms,
                                        dynamic_column_selection,
                                        local_row_block, topr_margin)
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
_DCT_METHODS = ("matmul", "fft")
_MOMENTUM_DTYPES = ("float32", "bfloat16")


class TrionLeaf(NamedTuple):
    m: torch.Tensor  # full-size momentum, stored oriented


@dataclasses.dataclass(frozen=True)
class TrionRule(MatrixRule):
    rank: int = 128
    mu: float = 0.95
    ns_steps: int = 5
    ranking_norm: str = "l2"
    dct_method: str = "matmul"       # "matmul" | "fft" (Makhoul), "off" path
    momentum_dtype: str = "float32"  # "float32" | "bfloat16"
    needs_shared_basis: bool = True
    fused: str = "auto"              # "auto" | "on" | "fft" | "off"
    emit_stats: bool = True          # SubspaceStats into ctx.stats

    def __post_init__(self):
        for name, value, allowed in (
                ("ranking_norm", self.ranking_norm, _RANKING_NORMS),
                ("dct_method", self.dct_method, _DCT_METHODS),
                ("momentum_dtype", self.momentum_dtype, _MOMENTUM_DTYPES),
                ("fused", self.fused, fused_step.FUSED_MODES)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; allowed: "
                                 f"{allowed}")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    @property
    def zero_shardable(self) -> bool:
        """Row-shardable by gather - compute - slice (module docstring)."""
        return True

    def init(self, shape, dtype, device=None):
        *batch, _, _ = shape
        rows, cols = oriented_dims(shape)
        return TrionLeaf(m=torch.zeros((*batch, rows, cols),
                                       dtype=getattr(torch, self.momentum_dtype),
                                       device=device))

    def update(self, g, state: TrionLeaf, param, ctx):
        if ctx.oriented:        # a ZeRO row block: right-oriented already
            gf, transposed = g.float(), False
        else:
            gf, transposed = orient_right(g.float())
        cols = gf.shape[-1]
        r = min(self.rank, cols)
        # the aspect ratio of the whole leaf (a ZeRO row block's differs)
        g_rows, g_cols = oriented_dims(param.shape)
        scale = max(1.0, (g_rows / g_cols) ** 0.5)
        mode = fused_step.resolve(self.fused, gf.device)

        want_stats = ctx.wants_stats and self.emit_stats

        # ZeRO: the whole momentum sum from every shard's rows (identity
        # when replicated); this rank's rows are cut out at the end
        block = gf.shape[-2]
        b_full = allgather_rows(state.m.float() + gf,
                                ctx.axis).contiguous()          # B_t
        q = ctx.basis(cols, torch.float32, device=gf.device)
        if mode != "off":
            sp = fused_step.select_and_project(
                b_full, q, r, norm=self.ranking_norm, mode=mode,
                return_norms=want_stats)
            idx, b = sp[0], sp[1]
            norms_sq = sp[2] if want_stats else None
        else:
            s = makhoul_dct2(b_full) if self.dct_method == "fft" else b_full @ q
            idx, b = dynamic_column_selection(s, r, ord=self.ranking_norm)
            norms_sq = column_norms(s, "l2") if want_stats else None
        if want_stats:
            col_e = torch.gather(norms_sq, -1, idx.long())
            sel_sq = col_e.sum(dim=-1)
            total_sq = norms_sq.sum(dim=-1)
            ctx.record_stats(tstats.SubspaceStats(
                captured_energy=tstats.captured_energy(sel_sq, total_sq),
                topr_margin=topr_margin(norms_sq, r),
                index_overlap=tstats.sentinel(b_full.shape[:-2],
                                              b_full.device),
                ef_norm=torch.sqrt(torch.clamp_min(total_sq - sel_sq, 0.0)),
                rank_utilization=tstats.rank_utilization(col_e)))

        o = fused_step.fused_newton_schulz(b, steps=self.ns_steps, mode=mode)
        # both back-projections share one Q_r^T gather
        out, low_rank_part = fused_step.fused_dual_backproject(
            o, b, q, idx, mode=mode, qt=ctx.basis_t(cols))
        new_m = b_full - (1.0 - self.mu) * low_rank_part        # Alg. 1 l. 10
        new_m = local_row_block(new_m, ctx.axis, block)
        out = local_row_block(out, ctx.axis, block)
        d = deorient(scale * out, transposed)
        return d, TrionLeaf(m=new_m.to(state.m.dtype))


def trion_transform(lr: Schedule, *, rank: int = 128, mu: float = 0.95,
                    weight_decay: float = 0.01, ns_steps: int = 5,
                    ranking_norm: str = "l2", dct_method: str = "matmul",
                    momentum_dtype: str = "float32",
                    fused: str = "auto") -> GradientTransform:
    """Matrix-leaf Trion pipeline (rule -> -lr -> decay) for ``partition``."""
    rule = TrionRule(rank=rank, mu=mu, ns_steps=ns_steps,
                     ranking_norm=ranking_norm, dct_method=dct_method,
                     momentum_dtype=momentum_dtype, fused=fused)
    return chain(lowrank_project(rule), scale_by_learning_rate(lr),
                 add_decayed_weights(weight_decay, schedule=lr))


def trion(lr: Schedule, *, rank: int = 128, mu: float = 0.95,
          weight_decay: float = 0.01, ns_steps: int = 5,
          ranking_norm: str = "l2", dct_method: str = "matmul",
          momentum_dtype: str = "float32", basis_mode: str = "stored",
          fused: str = "auto", b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, label_fn=None, zero=None,
          lr_scale: bool = False) -> Optimizer:
    """Trion on the matrix leaves, full-rank Adam on the rest. ``fused``:
    "auto" (the CUDA kernels for CUDA tensors, the reference path for CPU
    tensors) | "on" | "fft" | "off". ``zero``: a ``parallel.zero.
    ZeroConfig`` (ZeRO-1 on the active mesh)."""
    rule = TrionRule(rank=rank, mu=mu, ns_steps=ns_steps,
                     ranking_norm=ranking_norm, dct_method=dct_method,
                     momentum_dtype=momentum_dtype, fused=fused)
    kw = dict(weight_decay=weight_decay, basis_mode=basis_mode, b1=b1, b2=b2,
              eps=eps, zero=zero, lr_scale=lr_scale)
    if label_fn is not None:
        kw["label_fn"] = label_fn
    return matrix_optimizer(rule, lr, **kw)
