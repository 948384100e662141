"""Low-rank projected AdamW: the paper's DCT-AdamW (Algorithm 2).

Per matrix leaf (oriented so the projected dim is last, size n <= m):

    G_t  = grad + EF buffer
    refresh (every T_u steps): new indices from G_t; rotation
        R = Q_prev^T Q_crt applied to m, v (|.| on v) — a 0/1 partial
        permutation for index-based projectors (DESIGN.md §1)
    g_t  = G_t @ Q_crt                      (m x r)
    Xi   = G_t - g_t Q_crt^T                (residual -> EF buffer)
    m, v = Adam moments on g_t; u = mhat / (sqrt(vhat) + eps)
    D    = u @ Q_crt^T

With ``fused`` resolving to "on" or "fft" the hot path runs through
:mod:`repro_torch.core.fused_step` (one select+project pass over G, one
shared Q_r^T gather for both back-projections, int8 EF read and written by
fused kernels); "off" is the reference path.

Ported: every predefined-basis projector (``dct``, ``dst``, ``hadamard``,
``randortho``), residual ``ef`` with ``q8`` or ``fp32`` buffers and
``discard`` (no EF state, one back-projection), rotation,
``update_interval > 1`` (a Python branch on the step), and the projection
precisions ``compute_dtype`` fp32 / bf16 / int8 on the fused modes. Not yet
ported: the dense projectors and the ``sign`` / ``fira`` residuals (and with
them ldadamw / galore / frugal / fira), ZeRO-1, telemetry (``emit_stats`` is
kept but inert: there is no collector yet).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import fused_step
from repro_torch.core.error_feedback import zeros_q8
from repro_torch.core.projectors import Projector, rotation_matrix
from repro_torch.core.transforms import backend_kinds, get_backend, is_backend
from repro_torch.kernels.lowp import COMPUTE_DTYPES

from .common import MatrixRule, Optimizer, Schedule, deorient, orient_right, oriented_dims
from .transform import (
    GradientTransform,
    add_decayed_weights,
    chain,
    lowrank_project,
    matrix_optimizer,
    scale_by_learning_rate,
)

RESIDUAL_MODES = ("ef", "discard")
EF_DTYPES = ("q8", "fp32")
RANKING_NORMS = ("l1", "l2")


class ProjAdamLeaf(NamedTuple):
    m: torch.Tensor            # (..., rows, r) first moment, low-rank
    v: torch.Tensor            # (..., rows, r) second moment, low-rank
    proj: Any                  # int32 indices (..., r)
    ef: Any                    # None | fp32 tensor | QuantizedBuffer
    inner_step: int            # updates taken by this leaf (bias correction)


@dataclasses.dataclass(frozen=True)
class ProjectedAdamRule(MatrixRule):
    rank: int = 128
    projector: str = "dct"
    update_interval: int = 1          # T_u
    rotate: bool = True
    residual: str = "ef"
    ef_dtype: str = "q8"              # "fp32" | "q8"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    ranking_norm: str = "l2"
    exact_rotation_matmul: bool = False   # paper-literal R via matmul
    needs_shared_basis: bool = True
    fused: str = "auto"               # "auto" | "on" | "fft" | "off"
    emit_stats: bool = True           # inert until telemetry is ported
    compute_dtype: str = "fp32"       # projection precision on the fused
    #   modes: "fp32" | "bf16" | "int8" (kernels/lowp.py); the reference
    #   path has no low-precision mirror, so a non-fp32 dtype that would run
    #   there raises instead of silently running fp32

    def __post_init__(self):
        def check(name, value, allowed):
            if value not in allowed:
                raise ValueError(f"{type(self).__name__}: unknown {name} "
                                 f"{value!r}; allowed: {allowed}")

        Projector(kind=self.projector, r=1)        # raises on other kinds
        if self.residual in ("sign", "fira"):
            raise NotImplementedError(f"residual={self.residual!r} is not "
                                      f"yet ported to repro_torch")
        check("residual", self.residual, RESIDUAL_MODES)
        check("ef_dtype", self.ef_dtype, EF_DTYPES)
        check("ranking_norm", self.ranking_norm, RANKING_NORMS)
        check("fused", self.fused, fused_step.FUSED_MODES)
        check("compute_dtype", self.compute_dtype, COMPUTE_DTYPES)
        if self.compute_dtype != "fp32" and self.fused == "off":
            raise ValueError(
                f"{type(self).__name__}: compute_dtype={self.compute_dtype!r} "
                "requires the fused dataflow (fused='on'/'fft'); the fused"
                "='off' reference path has no low-precision mirror and would "
                "silently run fp32")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.update_interval < 1:
            raise ValueError(
                f"update_interval must be >= 1, got {self.update_interval}")

    def _proj(self):
        return Projector(kind=self.projector, r=self.rank,
                         norm=self.ranking_norm)

    def basis_sizes(self, shape) -> tuple:
        """The shared basis this leaf needs: ``(kind, n)`` at the min
        oriented dim (bare ``n`` for dct)."""
        n = oriented_dims(shape)[1]
        return ((self.projector, n),) if self.projector != "dct" else (n,)

    def init(self, shape, dtype, device=None):
        *batch, _, _ = shape
        rows, cols = oriented_dims(shape)
        r = min(self.rank, cols)
        mz = torch.zeros((*batch, rows, r), dtype=torch.float32, device=device)
        vz = torch.zeros((*batch, rows, r), dtype=torch.float32, device=device)
        orient_shape = (*batch, rows, cols)
        if self.residual == "discard":
            ef = None
        elif self.ef_dtype == "q8":
            ef = zeros_q8(orient_shape, device=device)
        else:
            ef = torch.zeros(orient_shape, dtype=torch.float32, device=device)
        return ProjAdamLeaf(m=mz, v=vz,
                            proj=self._proj().init(orient_shape, device),
                            ef=ef, inner_step=0)

    def update(self, g, state: ProjAdamLeaf, param, ctx):
        p = self._proj()
        # g.float() of an fp32 gradient is the gradient itself, and the
        # oriented view of it is contiguous only when not transposed; every
        # step below makes new tensors, none writes into gf or g
        gf, transposed = orient_right(g.float())
        gf = gf.contiguous()
        cols = gf.shape[-1]
        r = min(self.rank, cols)
        backend = get_backend(self.projector)
        q = ctx.basis(cols, torch.float32, kind=self.projector,
                      device=gf.device)
        mode = fused_step.resolve(self.fused, gf.device)
        fused = mode != "off"
        if self.compute_dtype != "fp32" and not fused:
            # only the fused dataflow has the low-precision mirror: refuse
            # rather than silently run fp32 (reachable past __post_init__
            # through fused="auto" resolving to "off" for CPU tensors; the
            # reference's other case, a dense projector, is not ported)
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r} needs the fused "
                f"dataflow, but this update resolved to the reference path "
                f"(fused={self.fused!r} -> mode={mode!r}, "
                f"projector={self.projector!r}); pass fused='on'/'fft' with "
                "a registered basis backend")

        if state.ef is not None:
            gf = fused_step.ef_add(gf, state.ef, mode=mode)

        refresh = (self.update_interval == 1
                   or ctx.step % self.update_interval == 1 or ctx.step == 1)
        rot = None
        if refresh:
            if fused:
                proj_state, g_low = fused_step.select_and_project(
                    gf, q, r, norm=self.ranking_norm, mode=mode,
                    backend=backend, compute_dtype=self.compute_dtype)
            else:
                proj_state = p.update(gf, state.proj, shared_q=q)
                g_low = p.project(gf, proj_state, shared_q=q)
            if self.rotate:
                rot = rotation_matrix(state.proj, proj_state, p, cols,
                                      shared_q=q,
                                      exact_matmul=self.exact_rotation_matmul)
        else:
            # keep step: stale indices, identity rotation (m @ I == m exactly)
            proj_state = state.proj
            g_low = (fused_step.project_with_indices(
                        gf, q, proj_state, compute_dtype=self.compute_dtype)
                     if fused else p.project(gf, proj_state, shared_q=q))

        if rot is not None:
            m_prev = state.m @ rot
            v_prev = torch.abs(state.v @ rot)
        else:
            m_prev, v_prev = state.m, state.v
        inner = state.inner_step + 1

        m = self.b1 * m_prev + (1.0 - self.b1) * g_low
        v = self.b2 * v_prev + (1.0 - self.b2) * g_low * g_low
        t = float(inner)
        mhat = m / (1.0 - self.b1**t)
        vhat = v / (1.0 - self.b2**t)
        u_low = mhat / (torch.sqrt(vhat) + self.eps)

        keep_resid = self.residual == "ef"
        qt = ctx.basis_t(cols, self.projector)
        if fused and keep_resid:
            d, recon = fused_step.fused_dual_backproject(
                u_low, g_low, q, proj_state, mode=mode,
                compute_dtype=self.compute_dtype, qt=qt)
        elif fused:
            d = fused_step.fused_backproject(
                u_low, q, proj_state, mode=mode,
                compute_dtype=self.compute_dtype, qt=qt)
        else:
            d = p.backproject(u_low, proj_state, shared_q=q, n=cols)
            if keep_resid:
                recon = p.backproject(g_low, proj_state, shared_q=q, n=cols)
        new_ef = (fused_step.ef_store(gf - recon, self.ef_dtype, mode=mode)
                  if keep_resid else None)

        d = deorient(d, transposed)
        return d, ProjAdamLeaf(m=m, v=v, proj=proj_state, ef=new_ef,
                               inner_step=inner)


def _rule(rule_kw) -> ProjectedAdamRule:
    rule_kw.setdefault("needs_shared_basis",
                       is_backend(rule_kw.get("projector")))
    return ProjectedAdamRule(**rule_kw)


def projected_adam_transform(rule: ProjectedAdamRule, lr: Schedule, *,
                             weight_decay: float = 0.0) -> GradientTransform:
    """Matrix-leaf projected-Adam pipeline (rule -> -lr -> decay)."""
    return chain(lowrank_project(rule),
                 scale_by_learning_rate(lr),
                 add_decayed_weights(weight_decay, schedule=lr))


def dct_adamw_transform(lr: Schedule, *, rank: int = 128,
                        update_interval: int = 1, weight_decay: float = 0.01,
                        error_feedback: bool = True, ef_dtype: str = "q8",
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        fused: str = "auto", basis: str = "dct",
                        compute_dtype: str = "fp32") -> GradientTransform:
    """Matrix-leaf DCT-AdamW pipeline for ``partition``."""
    rule = _rule(dict(rank=rank, projector=basis,
                      update_interval=update_interval, rotate=True,
                      residual="ef" if error_feedback else "discard",
                      ef_dtype=ef_dtype, b1=b1, b2=b2, eps=eps, fused=fused,
                      compute_dtype=compute_dtype))
    return projected_adam_transform(rule, lr, weight_decay=weight_decay)


def dct_adamw(lr: Schedule, *, rank: int = 128, update_interval: int = 1,
              weight_decay: float = 0.01, error_feedback: bool = True,
              ef_dtype: str = "q8", b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, exact_rotation_matmul: bool = False,
              fused: str = "auto", basis: str = "dct",
              compute_dtype: str = "fp32", basis_mode: str = "stored",
              label_fn=None) -> Optimizer:
    """The paper's DCT-AdamW (Algorithm 2). ``fused``: "auto" (the CUDA
    kernels for CUDA tensors, the reference path for CPU tensors) | "on" |
    "fft" (the backend's fast transform: Makhoul FFT for dct, FWHT for
    hadamard) | "off" (reference) — see core/fused_step.py. ``basis``: any
    registered basis backend (dct/dst/hadamard/randortho).
    ``error_feedback=False`` discards the residual (no EF state).
    ``compute_dtype``: the projection precision, fp32 | bf16 | int8, on the
    fused modes only."""
    if not is_backend(basis):
        raise ValueError(f"unknown basis {basis!r}; registered backends: "
                         f"{backend_kinds()}")
    hk = dict(weight_decay=weight_decay, basis_mode=basis_mode)
    if label_fn is not None:
        hk["label_fn"] = label_fn
    rule = _rule(dict(rank=rank, projector=basis,
                      update_interval=update_interval, rotate=True,
                      residual="ef" if error_feedback else "discard",
                      ef_dtype=ef_dtype, b1=b1, b2=b2, eps=eps,
                      exact_rotation_matmul=exact_rotation_matmul,
                      fused=fused, compute_dtype=compute_dtype))
    return matrix_optimizer(rule, lr, b1=rule.b1, b2=rule.b2, eps=rule.eps,
                            **hk)
