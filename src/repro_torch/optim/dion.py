"""Dion baseline (Ahn et al., 2025): low-rank orthonormal updates by an
amortized power iteration + QR (the method Trion replaces). The counterpart
of ``repro/optim/dion.py``.

Per 2D leaf (oriented, C <= R):
    B_t = M_{t-1} + G_t
    P_t = QR(B_t @ Q_{t-1}).Q           (power-iteration step, R x r)
    R_t = B_t^T P_t                      (C x r)
    M_t = B_t - (1-mu) P_t R_t^T         (error feedback)
    Q_t = column-normalize(R_t)          (next iteration's basis)
    O_t = P_t Q_t^T
    theta <- (1 - lr*wd) theta - lr * max(1, sqrt(R/C)) * O_t

State per leaf: the momentum M (stored *oriented*) plus a per-layer
projection matrix Q (C x r) — the extra memory the paper removes.

``fused`` picks the orthonormalization: "off" (and "auto" on the CPU) keeps
the QR, ``torch.linalg.qr`` (the JAX package calls ``jnp.linalg.qr`` outside
any kernel too); "on" (and "auto" on the card) and "fft" take the
Newton–Schulz polar factor of ``B Q`` instead, which reaches the CUDA
kernels on "on". Both factors span the same subspace. Column signs of a QR
differ between libraries, which flips the signs of ``P_t`` and ``Q_t``
together: ``M_t`` and ``O_t`` do not depend on them, the state ``Q_t`` does.

Telemetry (``emit_stats``, with a collector installed): ``P_t`` is
orthonormal, so the energy ``span(P_t)`` captures is ``||R_t||_F^2``; the
per-column energies of ``R_t`` play the part the selected column norms play
for Muon and Trion, ``ef_norm`` is ``||M_t||_F``, and margin and overlap
are the -1 sentinel (Dion ranks no columns).

ZeRO-1 (``zero=``, ``repro_torch.parallel.zero``): the rule is
``zero_shardable`` by gather - compute - slice: a rank all-gathers the
momentum sum (its ``B^T P`` contraction spans every row), runs the
whole-matrix step and keeps its rows of M_t and O_t; ``q`` comes out the
same on every rank and is held whole.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import fused_step
from repro_torch.core.selection import allgather_rows, local_row_block
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


class DionLeaf(NamedTuple):
    m: torch.Tensor  # full-size momentum, stored oriented
    q: torch.Tensor  # per-layer projection basis (C, r)


@dataclasses.dataclass(frozen=True)
class DionRule(MatrixRule):
    rank: int = 128
    mu: float = 0.95
    eps: float = 1e-8
    ns_steps: int = 5
    needs_shared_basis: bool = False
    fused: str = "auto"   # "off" / "auto" on the CPU: QR; "on" / "fft": NS
    emit_stats: bool = True  # SubspaceStats into ctx.stats

    def __post_init__(self):
        if self.fused not in fused_step.FUSED_MODES:
            raise ValueError(f"unknown fused mode {self.fused!r}; allowed: "
                             f"{fused_step.FUSED_MODES}")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    @property
    def zero_shardable(self) -> bool:
        """Row-shardable by gather - compute - slice (module docstring)."""
        return True

    def init(self, shape, dtype, device=None):
        *batch, _, _ = shape
        rows, cols = oriented_dims(shape)
        r = min(self.rank, cols)
        eye = torch.eye(cols, r, dtype=torch.float32, device=device)
        return DionLeaf(
            m=torch.zeros((*batch, rows, cols), dtype=torch.float32,
                          device=device),
            q=eye.expand(*batch, cols, r).contiguous())

    def update(self, g, state: DionLeaf, param, ctx):
        if ctx.oriented:        # a ZeRO row block: right-oriented already
            gf, transposed = g.float(), False
        else:
            gf, transposed = orient_right(g.float())
        # the aspect ratio of the whole leaf (a ZeRO row block's differs)
        g_rows, g_cols = oriented_dims(param.shape)
        scale = max(1.0, (g_rows / g_cols) ** 0.5)
        mode = fused_step.resolve(self.fused, gf.device)

        # ZeRO: the whole momentum sum (identity when replicated); this
        # rank's rows are cut out at the end
        block = gf.shape[-2]
        b_full = allgather_rows(gf + state.m, ctx.axis).contiguous()
        z = b_full @ state.q
        if mode == "off":
            p, _ = torch.linalg.qr(z)                    # R x r orthonormal
        else:
            # the Newton-Schulz polar factor in place of QR: the same column
            # span, r-sized Gram matrices, the CUDA kernels on "on"
            p = fused_step.fused_newton_schulz(z, steps=self.ns_steps,
                                               mode=mode)
        r_t = b_full.mT @ p
        new_m = b_full - (1.0 - self.mu) * (p @ r_t.mT)
        col_norm = torch.linalg.vector_norm(r_t, dim=-2, keepdim=True)
        q_t = r_t / (col_norm + self.eps)
        out = p @ q_t.mT                                   # O_t
        if ctx.wants_stats and self.emit_stats:
            col_e = (r_t * r_t).sum(dim=-2)
            batch = b_full.shape[:-2]
            ctx.record_stats(tstats.SubspaceStats(
                captured_energy=tstats.captured_energy(
                    col_e.sum(dim=-1), (b_full * b_full).sum(dim=(-2, -1))),
                topr_margin=tstats.sentinel(batch, b_full.device),
                index_overlap=tstats.sentinel(batch, b_full.device),
                ef_norm=torch.linalg.vector_norm(new_m, dim=(-2, -1)),
                rank_utilization=tstats.rank_utilization(col_e)))
        new_m = local_row_block(new_m, ctx.axis, block)
        out = local_row_block(out, ctx.axis, block)
        d = deorient(scale * out, transposed)
        return d, DionLeaf(m=new_m, q=q_t)


def dion_transform(lr: Schedule, *, rank: int = 128, mu: float = 0.95,
                   weight_decay: float = 0.01, ns_steps: int = 5,
                   fused: str = "auto") -> GradientTransform:
    """Matrix-leaf Dion pipeline (rule -> -lr -> decay) for ``partition``."""
    rule = DionRule(rank=rank, mu=mu, ns_steps=ns_steps, fused=fused)
    return chain(lowrank_project(rule), scale_by_learning_rate(lr),
                 add_decayed_weights(weight_decay, schedule=lr))


def dion(lr: Schedule, *, rank: int = 128, mu: float = 0.95,
         weight_decay: float = 0.01, ns_steps: int = 5, fused: str = "auto",
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, label_fn=None,
         zero=None, lr_scale: bool = False) -> Optimizer:
    """Dion on the matrix leaves, full-rank Adam on the rest. ``zero``: a
    ``parallel.zero.ZeroConfig`` (ZeRO-1 on the active mesh)."""
    rule = DionRule(rank=rank, mu=mu, ns_steps=ns_steps, fused=fused)
    kw = dict(weight_decay=weight_decay, b1=b1, b2=b2, eps=eps, zero=zero,
              lr_scale=lr_scale)
    if label_fn is not None:
        kw["label_fn"] = label_fn
    return matrix_optimizer(rule, lr, **kw)
