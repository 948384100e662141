"""Fused execution layer of the projected-Adam hot path (DESIGN.md §3).

The reference step computes, per predefined-basis leaf and step,
``S = G @ Q`` (ranking), ``g_low = G @ Q_r`` (a second pass over G), two
back-projections that each gather ``Q_r^T``, and a dequantized fp32 EF
temporary. The fused dataflow removes every redundancy: ``g_low`` is cut out
of ``S`` (paper Alg. 1 line 8), both back-projections share one gather, and
the int8 error-feedback buffer is read and written by fused kernels. The
momentum families (Trion, Muon, Dion) add ``fused_newton_schulz`` (the
Newton–Schulz kernels on the rank-sized factor) and ``fused_backproject``
(one back-projection).

Three concrete modes (``resolve`` maps a rule's ``fused`` field to one):

  ``"on"``  — the CUDA kernels (``kernels.ops``); on CPU tensors each
              wrapper runs its plain PyTorch version, which is how the
              parity tests run this mode.
  ``"fft"`` — the fused dataflow in plain PyTorch with ``S`` from the
              backend's fast transform (Makhoul FFT on ``torch.fft`` for
              DCT).
  ``"off"`` — the reference path.

A rule's ``"auto"`` takes the process-wide default
(``set_default_fused_mode``), itself ``"auto"`` unless set: that resolves
by the device of the tensors, ``"on"`` for CUDA tensors, ``"off"`` for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.dct import makhoul_dct2
from repro_torch.core.error_feedback import QuantizedBuffer, dequantize_q8, quantize_q8
from repro_torch.core.newton_schulz import newton_schulz
from repro_torch.core.selection import (
    allgather_rows,
    allsum,
    allsum_row_blocks,
    back_project,
    column_norms,
    dual_back_project,
    dynamic_column_selection,
    gather_columns,
    local_row_block,
    select_top_r,
    take_columns,
)
from repro_torch.kernels import lowp, ops

FUSED_MODES = ("auto", "off", "on", "fft")

# process-wide default consulted by rules whose ``fused`` is "auto"; itself
# "auto" = the kernels for CUDA tensors, the reference path for CPU ones
_DEFAULT_MODE = "auto"


def set_default_fused_mode(mode: str) -> None:
    """Override the process-wide dispatch default (benchmarks,
    experiments); ``"auto"`` restores the device rule."""
    global _DEFAULT_MODE
    if mode not in FUSED_MODES:
        raise ValueError(f"unknown fused mode {mode!r}; expected one of "
                         f"{FUSED_MODES}")
    _DEFAULT_MODE = mode


def default_fused_mode() -> str:
    return _DEFAULT_MODE


def resolve(mode: str, device: torch.device | str) -> str:
    """Rule-level mode -> concrete mode in {"off", "on", "fft"} for tensors
    on ``device``."""
    if mode not in FUSED_MODES:
        raise ValueError(f"unknown fused mode {mode!r}; expected one of "
                         f"{FUSED_MODES}")
    if mode == "auto":
        mode = _DEFAULT_MODE
    if mode == "auto":
        return "on" if torch.device(device).type == "cuda" else "off"
    return mode


def select_and_project(gf: torch.Tensor, q: torch.Tensor, r: int, *,
                       norm: str = "l2", mode: str,
                       return_norms: bool = False, psum_axes=None,
                       backend=None, compute_dtype: str = "fp32"):
    """Dynamic column selection + low-rank extraction in one pass over G.

    Returns ``(idx (..., r), g_low (..., m, r))``, plus the squared-l2
    column norms of ``S`` (..., n) with ``return_norms``. On the kernel path
    the norms come out of the ``S = G @ Q`` kernel itself; the fft path
    computes ``S`` by the backend's fast transform. Either way ``g_low`` is
    sliced out of ``S`` (``S[:, idx] == G @ Q[:, idx]``).

    ``compute_dtype`` in {"fp32", "bf16", "int8"}: the kernel path passes it
    to ``dct_project``; the off/fft paths run the mirror
    ``lowp.lowp_matmul`` instead of the fast transform (there is no int8
    FFT, and the mirror's exact integer sum keeps the modes in lockstep).

    ``psum_axes``: the mesh axes the rows of ``gf`` are split over (ZeRO-1,
    ``parallel/zero.py``): the column statistic is completed across them,
    so every shard selects the same indices. On the kernel path it is the
    fixed-order sum of every shard's ``dct_project`` row-block partials
    (the replicated kernel's own sum when the shards' rows are whole
    blocks); off it, the shards' column totals summed in shard order.
    """
    lowp.check_compute_dtype(compute_dtype)
    if mode == "on":
        if psum_axes:
            s, _, partial = ops.dct_project(gf, q, compute_dtype=compute_dtype,
                                            partials=True)
            norms_sq = allsum_row_blocks(partial, psum_axes)
        else:
            s, norms_sq = ops.dct_project(gf, q, compute_dtype=compute_dtype)
            norms_sq = allsum(norms_sq, psum_axes)
        rank_norms = (norms_sq if norm == "l2"
                      else allsum(column_norms(s, norm), psum_axes))
        idx = select_top_r(rank_norms, r)
        g_low = take_columns(s, idx)
        return (idx, g_low, norms_sq) if return_norms else (idx, g_low)
    if compute_dtype != "fp32":
        s = lowp.lowp_matmul(gf, q, compute_dtype)
    else:
        s = backend.apply_fast(gf, q) if backend is not None \
            else makhoul_dct2(gf)
    if not return_norms and psum_axes is None:
        return dynamic_column_selection(s, r, ord=norm)
    norms_sq = allsum(column_norms(s, "l2"), psum_axes)
    rank_norms = (norms_sq if norm == "l2"
                  else allsum(column_norms(s, norm), psum_axes))
    idx = select_top_r(rank_norms, r)
    g_low = take_columns(s, idx)
    return (idx, g_low, norms_sq) if return_norms else (idx, g_low)


def project_with_indices(gf: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
                         *, compute_dtype: str = "fp32") -> torch.Tensor:
    """Keep-branch projection ``G @ Q[:, idx]`` for non-refresh steps
    (T_u > 1): a gather and a skinny matmul, no full-width ``S``; in
    ``compute_dtype`` through ``lowp.lowp_matmul``."""
    qr = gather_columns(q, idx)
    if lowp.check_compute_dtype(compute_dtype) != "fp32":
        return lowp.lowp_matmul(gf, qr.float(), compute_dtype)
    return gf @ qr.to(gf.dtype)


def fused_dual_backproject(u_low: torch.Tensor, g_low: torch.Tensor,
                           q: torch.Tensor, idx: torch.Tensor, *, mode: str,
                           compute_dtype: str = "fp32",
                           qt: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(u_low @ Q_r^T, g_low @ Q_r^T)`` sharing one ``Q_r^T`` gather.

    ``qt``: a contiguous ``Q^T`` cached by the caller for the kernel path
    (the kernel reads rows of ``Q^T`` from memory; ``q.T`` is only a view).
    Without one, the kernel path makes the copy itself. Off the kernel
    path a non-fp32 ``compute_dtype`` runs the mirror
    ``lowp.lowp_gather_matmul``.
    """
    lowp.check_compute_dtype(compute_dtype)
    if mode == "on":
        if qt is None:
            qt = q.T.contiguous()
        return ops.colgather_matmul_dual(u_low.contiguous(),
                                         g_low.contiguous(), qt,
                                         idx.contiguous(),
                                         compute_dtype=compute_dtype)
    if compute_dtype != "fp32":
        d, recon = lowp.lowp_gather_matmul((u_low, g_low), q.T, idx,
                                           compute_dtype)
        return d.to(u_low.dtype), recon.to(g_low.dtype)
    return dual_back_project(u_low, g_low, q, idx)


def fused_backproject(u_low: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
                      *, mode: str, compute_dtype: str = "fp32",
                      qt: torch.Tensor | None = None) -> torch.Tensor:
    """``u_low @ Q_r^T``: one back-projection (subspace Muon's update, and
    DCT-AdamW's when it keeps no residual). ``qt`` and ``compute_dtype`` as
    for ``fused_dual_backproject``."""
    lowp.check_compute_dtype(compute_dtype)
    if mode == "on":
        if qt is None:
            qt = q.T.contiguous()
        return ops.colgather_matmul(u_low.contiguous(), qt, idx.contiguous(),
                                    compute_dtype=compute_dtype)
    if compute_dtype != "fp32":
        (d,) = lowp.lowp_gather_matmul((u_low,), q.T, idx, compute_dtype)
        return d.to(u_low.dtype)
    return back_project(u_low, q, idx)


# The JAX package's NS_PALLAS_MAX_RANK = 512 is a TPU limit: its kernel keeps
# the (r, r) Gram and polynomial resident in VMEM. The CUDA kernels keep
# neither on chip (the Gram and the polynomial live in device memory); the
# apply kernel holds an (r, 64) stripe of X in shared memory, which bounds it
# at r <= 768 (kernels/newton_schulz.APPLY_MAX_RANK). The constant is kept
# at the reference's value, inside that envelope. Full-space Muon's
# llama-350m moments (short side 1024) run the plain iteration, as in the
# reference.
NS_KERNEL_MAX_RANK = 512


def fused_newton_schulz(b: torch.Tensor, *, steps: int, mode: str,
                        gather_axes=None) -> torch.Tensor:
    """Orthogonalize ``b`` by Newton–Schulz: the CUDA kernels on the "on"
    path (``ops.newton_schulz_kernel``), the plain iteration otherwise and
    for factors whose short side exceeds ``NS_KERNEL_MAX_RANK``.

    ``b`` is the (..., m, r) low-rank factor on the subspace path, or the
    full (..., m, n) moment of full-space Muon. ``gather_axes``: the mesh
    axes the rows are split over under ZeRO-1. NS mixes rows through its
    Gram matrix, so the factor is all-gathered, every shard runs the same
    whole-matrix iteration and keeps its own rows: the same bits as the
    replicated step, and only a rank-sized factor crosses the shards on the
    subspace path.
    """
    block = b.shape[-2]
    bf = allgather_rows(b, gather_axes)
    if mode == "on" and min(bf.shape[-2:]) <= NS_KERNEL_MAX_RANK:
        o = ops.newton_schulz_kernel(bf, steps=steps)
    else:
        o = newton_schulz(bf, steps=steps)
    return local_row_block(o, gather_axes, block)


def ef_add(gf: torch.Tensor, ef, *, mode: str) -> torch.Tensor:
    """``G + EF`` as a new tensor — the fused dequant-add on the kernel path,
    so the dequantized fp32 buffer never exists in device memory."""
    if isinstance(ef, QuantizedBuffer):
        if mode == "on":
            return ops.dequant_add_ef(gf, ef.q, ef.scale)
        return gf + dequantize_q8(ef)
    return gf + ef


def ef_store(resid: torch.Tensor, ef_dtype: str, *, mode: str):
    """Residual -> EF buffer (int8 payload written in one pass)."""
    if ef_dtype == "q8":
        if mode == "on":
            qv, scale = ops.quantize_ef(resid)
            return QuantizedBuffer(q=qv, scale=scale)
        return quantize_q8(resid)
    return resid
