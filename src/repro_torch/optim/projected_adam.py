"""Generic low-rank projected AdamW — one rule, five optimizers.

The projector (DCT dynamic column selection vs SVD vs block power iteration
vs random/randperm) is a swappable component inside an otherwise identical
low-rank Adam(W):

  optimizer   projector   T_u    rotate   residual handling
  ---------   ---------   ----   ------   -----------------
  DCT-AdamW   dct         any    yes      error feedback (fp32 or int8)
  LDAdamW     power       1      yes      error feedback (fp32)
  GaLore      svd         200    no       discarded
  FRUGAL      svd/dct/..  200    no       SignSGD on the state-free part
  FIRA        svd/dct     200    no       norm-scaled pass-through

Per matrix leaf (oriented so the projected dim is last, size n <= m):

    G_t  = grad (+ EF buffer)
    refresh (every T_u steps): new indices/basis from G_t; rotation
        R = Q_prev^T Q_crt applied to m, v (|.| on v) — a 0/1 partial
        permutation for index-based projectors (DESIGN.md §1)
    g_t  = G_t @ Q_crt                      (m x r)
    Xi   = G_t - g_t Q_crt^T                (residual; see table)
    m, v = Adam moments on g_t; u = mhat / (sqrt(vhat) + eps)
    D    = u @ Q_crt^T (+ residual term)

For a predefined-basis projector with ``fused`` resolving to "on" or "fft"
the hot path runs through :mod:`repro_torch.core.fused_step` (one
select+project pass over G, one shared Q_r^T gather for both
back-projections, int8 EF read and written by fused kernels); "off" is the
reference path. The dense projectors always take the reference math, as in
the JAX package: ``torch.linalg`` refreshes and matmuls on the gradient's
device (only their EF buffer goes through ``fused_step``).

Telemetry (``emit_stats``, with a collector installed: ``repro_torch.
telemetry``): each update records the leaf's :class:`SubspaceStats` from
tensors it already holds. On a fused refresh step the total energy is the
sum of the column norms ``select_and_project`` returns (on the kernel path
they come out of ``dct_project`` itself), the selected energies a gather of
them; on a keep step margin and overlap are the -1 sentinel and the total
is one reduction over ``G``; ``ef_norm`` is the orthogonal split
``sqrt(||G||^2 - ||g_low||^2)``, never a reduction over the residual.

ZeRO-1 (``zero=``, ``repro_torch.parallel.zero``): the index-basis rules
are ``zero_shardable``. On a row block (``ctx.oriented``) the column
statistic of a refresh, and the keep step's telemetry totals, are completed
across the shards (``ctx.axis``); everything else is row-local.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import fused_step
from repro_torch.core.error_feedback import zeros_q8
from repro_torch.core.projectors import Projector, projector_kinds, rotation_matrix
from repro_torch.core.selection import index_overlap, topr_margin
from repro_torch.core.transforms import backend_kinds, get_backend, is_backend
from repro_torch.kernels.lowp import COMPUTE_DTYPES
from repro_torch.telemetry import stats as tstats

from .common import (MatrixRule, Optimizer, Schedule, deorient, orient_right,
                     oriented_dims)
from .transform import (
    GradientTransform,
    add_decayed_weights,
    chain,
    lowrank_project,
    matrix_optimizer,
    scale_by_learning_rate,
)

RESIDUAL_MODES = ("ef", "discard", "sign", "fira")
EF_DTYPES = ("q8", "fp32")
RANKING_NORMS = ("l1", "l2")


class ProjAdamLeaf(NamedTuple):
    m: torch.Tensor            # (..., rows, r) first moment, low-rank
    v: torch.Tensor            # (..., rows, r) second moment, low-rank
    proj: Any                  # int32 indices (..., r) or fp32 basis (..., n, r)
    ef: Any                    # None | fp32 tensor | QuantizedBuffer
    inner_step: int            # updates taken by this leaf (bias correction)


@dataclasses.dataclass(frozen=True)
class ProjectedAdamRule(MatrixRule):
    rank: int = 128
    projector: str = "dct"
    update_interval: int = 1          # T_u
    rotate: bool = True
    residual: str = "ef"              # "ef" | "discard" | "sign" | "fira"
    ef_dtype: str = "q8"              # "fp32" | "q8"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    ranking_norm: str = "l2"
    exact_rotation_matmul: bool = False   # paper-literal R via matmul
    needs_shared_basis: bool = True
    fused: str = "auto"               # "auto" | "on" | "fft" | "off"
    emit_stats: bool = True           # record SubspaceStats when a
    #   telemetry collector is installed (``ctx.stats``)
    compute_dtype: str = "fp32"       # projection precision on the fused
    #   modes: "fp32" | "bf16" | "int8" (kernels/lowp.py); the reference
    #   path has no low-precision mirror, so a non-fp32 dtype that would run
    #   there raises instead of silently running fp32

    def __post_init__(self):
        def check(name, value, allowed):
            if value not in allowed:
                raise ValueError(f"{type(self).__name__}: unknown {name} "
                                 f"{value!r}; allowed: {allowed}")

        check("projector", self.projector, projector_kinds())
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

    @property
    def zero_shardable(self) -> bool:
        """Index-into-shared-basis projectors (a backend with a
        row-decomposable statistic, or randperm) keep r integers of state
        and a row-parallel step: the ZeRO-1 precondition. The dense-basis
        refreshes and the FIRA residual (norms summed over the shards in
        the update arithmetic) are not."""
        if self.residual == "fira":
            return False
        if is_backend(self.projector):
            return get_backend(self.projector).zero_shardable
        return self.projector == "randperm"

    def _proj(self):
        return Projector(kind=self.projector, r=self.rank,
                         norm=self.ranking_norm)

    def basis_sizes(self, shape) -> tuple:
        """The shared basis this leaf needs: ``(kind, n)`` at the min
        oriented dim (bare ``n`` for dct). The dense kinds need none, even
        with ``needs_shared_basis`` left True on the rule."""
        if not is_backend(self.projector):
            return ()
        n = oriented_dims(shape)[1]
        return ((self.projector, n),) if self.projector != "dct" else (n,)

    def init(self, shape, dtype, device=None):
        *batch, _, _ = shape
        rows, cols = oriented_dims(shape)
        r = min(self.rank, cols)
        mz = torch.zeros((*batch, rows, r), dtype=torch.float32, device=device)
        vz = torch.zeros((*batch, rows, r), dtype=torch.float32, device=device)
        orient_shape = (*batch, rows, cols)
        if self.residual != "ef":
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
        if ctx.oriented:        # a ZeRO row block: right-oriented already
            gf, transposed = g.float(), False
        else:
            gf, transposed = orient_right(g.float())
        gf = gf.contiguous()
        cols = gf.shape[-1]
        r = min(self.rank, cols)
        backend = get_backend(self.projector) if p.needs_shared_basis else None
        q = (ctx.basis(cols, torch.float32, kind=self.projector,
                       device=gf.device) if p.needs_shared_basis else None)
        mode = fused_step.resolve(self.fused, gf.device)
        # the fused dataflow exists for the predefined-basis projectors; the
        # dense kinds keep the reference math (their EF still goes fused)
        fused = mode != "off" and backend is not None
        if self.compute_dtype != "fp32" and not fused:
            # only the fused dataflow has the low-precision mirror: refuse
            # rather than silently run fp32 (reachable past __post_init__
            # through fused="auto" resolving to "off" for CPU tensors, or a
            # dense projector)
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r} needs the fused "
                f"dataflow, but this update resolved to the reference path "
                f"(fused={self.fused!r} -> mode={mode!r}, "
                f"projector={self.projector!r}); pass fused='on'/'fft' with "
                "a registered basis backend")

        if state.ef is not None:
            gf = fused_step.ef_add(gf, state.ef, mode=mode)

        want_stats = ctx.wants_stats and self.emit_stats
        refresh = (self.update_interval == 1
                   or ctx.step % self.update_interval == 1 or ctx.step == 1)
        rot = None
        norms_sq = None
        if refresh:
            if fused:
                sp = fused_step.select_and_project(
                    gf, q, r, norm=self.ranking_norm, mode=mode,
                    return_norms=want_stats, psum_axes=ctx.axis,
                    backend=backend, compute_dtype=self.compute_dtype)
                proj_state, g_low = sp[0], sp[1]
                norms_sq = sp[2] if want_stats else None
            else:
                proj_state = p.update(gf, state.proj, shared_q=q, key=ctx.key,
                                      psum_axes=ctx.axis)
                g_low = p.project(gf, proj_state, shared_q=q)
            if self.rotate:
                rot = rotation_matrix(state.proj, proj_state, p, cols,
                                      shared_q=q,
                                      exact_matmul=self.exact_rotation_matmul)
        else:
            # keep step: stale basis, identity rotation (m @ I == m exactly)
            proj_state = state.proj
            g_low = (fused_step.project_with_indices(
                        gf, q, proj_state, compute_dtype=self.compute_dtype)
                     if fused else p.project(gf, proj_state, shared_q=q))
        if want_stats:
            # no later op of the step writes into any tensor read here
            ctx.record_stats(self._stats(ctx, gf, g_low, norms_sq,
                                         state.proj, proj_state, refresh,
                                         p.index_based, r))

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

        need_resid = self.residual != "discard"
        qt = ctx.basis_t(cols, self.projector) if fused else None
        if fused and need_resid:
            d, recon = fused_step.fused_dual_backproject(
                u_low, g_low, q, proj_state, mode=mode,
                compute_dtype=self.compute_dtype, qt=qt)
        elif fused:
            d = fused_step.fused_backproject(
                u_low, q, proj_state, mode=mode,
                compute_dtype=self.compute_dtype, qt=qt)
        else:
            d = p.backproject(u_low, proj_state, shared_q=q, n=cols)
            if need_resid:
                recon = p.backproject(g_low, proj_state, shared_q=q, n=cols)

        new_ef = None
        if need_resid:
            resid = gf - recon
            if self.residual == "ef":
                new_ef = fused_step.ef_store(resid, self.ef_dtype, mode=mode)
            elif self.residual == "sign":
                d = d + torch.sign(resid)                   # FRUGAL state-free
            else:
                # FIRA scaling: norms over the last two axes per stacked
                # layer, summed over the ZeRO axes (none: identity)
                u_n = torch.sqrt(ctx.psum(
                    (u_low * u_low).sum(dim=(-2, -1), keepdim=True)))
                g_n = torch.sqrt(ctx.psum(
                    (g_low * g_low).sum(dim=(-2, -1), keepdim=True)))
                d = d + (u_n / (g_n + self.eps)) * resid

        d = deorient(d, transposed)
        return d, ProjAdamLeaf(m=m, v=v, proj=proj_state, ef=new_ef,
                               inner_step=inner)

    def _stats(self, ctx, gf, g_low, norms_sq, prev_proj, proj_state,
               refresh, idx_based, r) -> "tstats.SubspaceStats":
        """The leaf's SubspaceStats, from what the update already holds.

        A fused refresh has the squared column norms of ``S = G Q``
        (``norms_sq``): the total energy is their sum (Q orthogonal:
        ||S||^2 == ||G||^2) and the selected energies a gather of them at
        the new indices. Elsewhere the total is one reduction over ``gf``
        and the selected energies one over the skinny ``g_low``. A keep
        step ran no selection: margin and overlap are the -1 sentinel, as
        is the overlap of a projector that keeps no indices. On a ZeRO row
        block both reductions are summed over the shards (``ctx.psum``)."""
        batch = gf.shape[:-2]
        if norms_sq is not None:
            total_sq = norms_sq.sum(dim=-1)
            col_e = torch.gather(norms_sq, -1, proj_state.long())
            margin = topr_margin(norms_sq, r)
        else:
            total_sq = ctx.psum((gf * gf).sum(dim=(-2, -1)))
            col_e = ctx.psum((g_low * g_low).sum(dim=-2))
            margin = tstats.sentinel(batch, gf.device)
        overlap = (index_overlap(prev_proj, proj_state)
                   if refresh and idx_based
                   else tstats.sentinel(batch, gf.device))
        sel_sq = col_e.sum(dim=-1)
        if self.residual == "ef":
            # the orthogonal split ||Xi||^2 = ||G||^2 - ||g_low||^2
            ef_norm = torch.sqrt(torch.clamp_min(total_sq - sel_sq, 0.0))
        else:
            ef_norm = torch.zeros(batch, dtype=torch.float32,
                                  device=gf.device)
        return tstats.SubspaceStats(
            captured_energy=tstats.captured_energy(sel_sq, total_sq),
            topr_margin=margin, index_overlap=overlap, ef_norm=ef_norm,
            rank_utilization=tstats.rank_utilization(col_e))


def _rule(rule_kw) -> ProjectedAdamRule:
    rule_kw.setdefault("needs_shared_basis",
                       is_backend(rule_kw.get("projector")))
    return ProjectedAdamRule(**rule_kw)


def _build(lr, rule_kw, harness_kw) -> Optimizer:
    rule = _rule(rule_kw)
    return matrix_optimizer(rule, lr, b1=rule.b1, b2=rule.b2, eps=rule.eps,
                            **harness_kw)


def _harness(weight_decay, overrides, label_fn, zero, **kw) -> dict:
    hk = dict(weight_decay=weight_decay, overrides=overrides, zero=zero,
              **kw)
    if label_fn is not None:
        hk["label_fn"] = label_fn
    return hk


def projected_adam_transform(rule: ProjectedAdamRule, lr: Schedule, *,
                             weight_decay: float = 0.0,
                             overrides: dict[str, dict] | None = None
                             ) -> GradientTransform:
    """Matrix-leaf projected-Adam pipeline (rule -> -lr -> decay)."""
    return chain(lowrank_project(rule, overrides=overrides),
                 scale_by_learning_rate(lr),
                 add_decayed_weights(weight_decay, schedule=lr))


def dct_adamw_transform(lr: Schedule, *, rank: int = 128,
                        update_interval: int = 1, weight_decay: float = 0.01,
                        error_feedback: bool = True, ef_dtype: str = "q8",
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        fused: str = "auto", basis: str = "dct",
                        compute_dtype: str = "fp32",
                        overrides: dict | None = None) -> GradientTransform:
    """Matrix-leaf DCT-AdamW pipeline for ``partition``."""
    rule = _rule(dict(rank=rank, projector=basis,
                      update_interval=update_interval, rotate=True,
                      residual="ef" if error_feedback else "discard",
                      ef_dtype=ef_dtype, b1=b1, b2=b2, eps=eps, fused=fused,
                      compute_dtype=compute_dtype))
    return projected_adam_transform(rule, lr, weight_decay=weight_decay,
                                    overrides=overrides)


def dct_adamw(lr: Schedule, *, rank: int = 128, update_interval: int = 1,
              weight_decay: float = 0.01, error_feedback: bool = True,
              ef_dtype: str = "q8", b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, exact_rotation_matmul: bool = False,
              fused: str = "auto", basis: str = "dct",
              compute_dtype: str = "fp32", basis_mode: str = "stored",
              label_fn=None, overrides: dict | None = None,
              zero=None, lr_scale: bool = False) -> Optimizer:
    """The paper's DCT-AdamW (Algorithm 2). ``fused``: "auto" (the CUDA
    kernels for CUDA tensors, the reference path for CPU tensors) | "on" |
    "fft" (the backend's fast transform: Makhoul FFT for dct, FWHT for
    hadamard) | "off" (reference) — see core/fused_step.py. ``basis``: any
    registered basis backend (dct/dst/hadamard/randortho).
    ``error_feedback=False`` discards the residual (no EF state).
    ``compute_dtype``: the projection precision, fp32 | bf16 | int8, on the
    fused modes only. ``overrides``: per-leaf-path rule field
    replacements. ``zero``: a ``parallel.zero.ZeroConfig`` (ZeRO-1 on the
    active mesh). ``lr_scale=True`` appends the resilience ladder's LR-cut
    seam (``transform.lr_scale_transform``)."""
    if not is_backend(basis):
        raise ValueError(f"unknown basis {basis!r}; registered backends: "
                         f"{backend_kinds()}")
    return _build(lr, dict(rank=rank, projector=basis,
                           update_interval=update_interval, rotate=True,
                           residual="ef" if error_feedback else "discard",
                           ef_dtype=ef_dtype, b1=b1, b2=b2, eps=eps,
                           exact_rotation_matmul=exact_rotation_matmul,
                           fused=fused, compute_dtype=compute_dtype),
                  _harness(weight_decay, overrides, label_fn, zero,
                           basis_mode=basis_mode, lr_scale=lr_scale))


def ldadamw(lr: Schedule, *, rank: int = 128, weight_decay: float = 0.01,
            error_feedback: bool = True, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, fused: str = "auto", label_fn=None,
            overrides: dict | None = None, zero=None,
            lr_scale: bool = False) -> Optimizer:
    """LDAdamW baseline: block power iteration, a new subspace every step,
    rotation by the r x r matmul of two stored bases, fp32 error feedback.
    ``fused`` covers the EF only (the power projector keeps the reference
    math)."""
    return _build(lr, dict(rank=rank, projector="power", update_interval=1,
                           rotate=True,
                           residual="ef" if error_feedback else "discard",
                           ef_dtype="fp32", b1=b1, b2=b2, eps=eps,
                           fused=fused),
                  _harness(weight_decay, overrides, label_fn, zero,
                           lr_scale=lr_scale))


def galore(lr: Schedule, *, rank: int = 128, update_interval: int = 200,
           weight_decay: float = 0.01, projector: str = "svd",
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           fused: str = "auto", label_fn=None,
           overrides: dict | None = None, zero=None,
           lr_scale: bool = False) -> Optimizer:
    """GaLore baseline: SVD every T_u steps, residual discarded, no
    rotation. ``projector``: any projector kind (svd, or a basis backend,
    which runs the fused dataflow)."""
    return _build(lr, dict(rank=rank, projector=projector,
                           update_interval=update_interval, rotate=False,
                           residual="discard", b1=b1, b2=b2, eps=eps,
                           fused=fused),
                  _harness(weight_decay, overrides, label_fn, zero,
                           lr_scale=lr_scale))


def frugal(lr: Schedule, *, rank: int = 128, update_interval: int = 200,
           weight_decay: float = 0.01, projector: str = "svd",
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           fused: str = "auto", label_fn=None,
           overrides: dict | None = None, zero=None,
           lr_scale: bool = False) -> Optimizer:
    """FRUGAL baseline: state-full low-rank AdamW + state-free SignSGD on the
    residual. ``projector`` in {svd, random, randperm} or any registered
    basis backend (dct/dst/hadamard/randortho, paper Table 6)."""
    return _build(lr, dict(rank=rank, projector=projector,
                           update_interval=update_interval, rotate=False,
                           residual="sign", b1=b1, b2=b2, eps=eps,
                           fused=fused),
                  _harness(weight_decay, overrides, label_fn, zero,
                           lr_scale=lr_scale))


def fira(lr: Schedule, *, rank: int = 128, update_interval: int = 200,
         weight_decay: float = 0.01, projector: str = "svd",
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         fused: str = "auto", label_fn=None,
         overrides: dict | None = None, zero=None,
         lr_scale: bool = False) -> Optimizer:
    """FIRA baseline: low-rank AdamW + norm-scaled full-rank residual."""
    return _build(lr, dict(rank=rank, projector=projector,
                           update_interval=update_interval, rotate=False,
                           residual="fira", b1=b1, b2=b2, eps=eps,
                           fused=fused),
                  _harness(weight_decay, overrides, label_fn, zero,
                           lr_scale=lr_scale))
