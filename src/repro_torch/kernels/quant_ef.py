"""Bandwidth-bound int8 kernels: the error feedback (paper §2.4) and the
int8 ``dct_project``'s operand quantizers.

* ``quantize_ef``    — residual (..., m, n) fp32 -> (int8 payload, per-row
  fp32 scale) in one read of the residual.
* ``dequant_add_ef`` — ``G + q * scale`` in one pass, so the dequantized fp32
  EF buffer never exists in device memory.
* ``quant_rows_q8``  — ``lowp.quant_rows`` of ``G`` for the int8
  projection: the same kernel as ``quantize_ef`` (the same function),
  counted on its own name so a run tells the EF buffer's launches from the
  projection's.
* ``quant_cols_q8t`` — ``lowp.quant_cols`` of the basis ``Q`` (k, n) with
  its codes written transposed, ``(n, k)``: column j of ``Q`` is row j of
  ``Q^T``, so the codes and scales are ``quant_rows(Q^T)``'s bit for bit.
  The int8 projection kernel reads its B operand in that layout.
* ``quant_qt_q8``    — ``lowp.quant_rows`` of ``Q^T`` for the int8
  ``colgather_matmul``: the same kernel again, counted on its own name.
* ``quant_fold_q8``  — the int8 ``colgather_matmul``'s ``b`` operands, one
  launch for both of a dual call: each ``b`` times the scales of the
  selected rows of ``Q^T`` (column k takes ``s_qt[idx[k]]``), then
  ``quant_rows``; codes and scales bit for bit.

On a CUDA tensor each wrapper launches its kernel from ``csrc/quant_ef.cu``
(replacing ``repro/kernels/quant_ef.py::_quant_kernel`` and
``::_dequant_add_kernel``, and the jnp quantizers of
``repro/kernels/lowp.py`` and ``repro/kernels/colgather_matmul.py``; bound
by bytes — see the source note) or raises.
On a CPU tensor it runs the plain PyTorch version beside it, which is also
what the kernels are held against on the card. Leading stacked-layer axes
collapse into the row count, so a ``(layers, m, n)`` leaf is one launch.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import q8_scale, quant_rows


def quantize_ef_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per-row amax, ``q8_scale``, IEEE division, round half
    to even (``torch.round``), clip to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = q8_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequant_add_ef_plain(g: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    return (g.float() + q.float() * scale).to(g.dtype)


def quant_cols_q8t_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quant_cols_q8t``: the rows of ``x^T`` quantized
    (``quant_rows``), codes made contiguous, scales as a row."""
    codes, scale = quant_rows(x.mT)
    return codes.contiguous(), scale.mT.contiguous()


def _quantize_rows(name: str, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the per-row quantizer on a CUDA tensor."""
    cuda_lib.require_cuda(f"{name} x", x, torch.float32)
    *batch, m, n = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*batch, m, 1), dtype=torch.float32, device=x.device)
    rows = x.numel() // n if n else 0
    if rows >= 2**31:
        raise ValueError(f"{name}: {rows} rows exceed the grid")
    rc = getattr(cuda_lib.library(), f"repro_{name}")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
        cuda_lib.stream(x))
    cuda_lib.check(rc, name)
    return q, scale


def quantize_ef(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., m, n) fp -> ((..., m, n) int8, (..., m, 1) fp32 row scales)."""
    if x.device.type == "cpu":
        return quantize_ef_plain(x)
    out = _quantize_rows("quantize_ef", x)
    quantize_ef.launches += 1
    return out


def quant_rows_q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``lowp.quant_rows``: (..., m, n) fp32 -> ((..., m, n) int8, (..., m,
    1) fp32 row scales), codes and scales bit for bit."""
    if x.device.type == "cpu":
        return quant_rows(x)
    out = _quantize_rows("quant_rows_q8", x)
    quant_rows_q8.launches += 1
    return out


def quant_cols_q8t(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``lowp.quant_cols`` with the codes transposed: (k, n) fp32 -> ((n, k)
    int8 codes of ``x^T``, (1, n) fp32 column scales)."""
    if x.dim() != 2:
        raise ValueError(f"quant_cols_q8t: expected a matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return quant_cols_q8t_plain(x)
    cuda_lib.require_cuda("quant_cols_q8t x", x, torch.float32)
    k, n = x.shape
    codes = torch.empty((n, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((1, n), dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().repro_quant_cols_q8t(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), k, n,
        cuda_lib.stream(x))
    cuda_lib.check(rc, "quant_cols_q8t")
    quant_cols_q8t.launches += 1
    return codes, scale


def quant_qt_q8(qt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``lowp.quant_rows`` of ``Q^T`` (n, n) for the int8 back-projection:
    ((n, n) int8 codes, (n, 1) fp32 row scales), bit for bit."""
    if qt.device.type == "cpu":
        return quant_rows(qt)
    out = _quantize_rows("quant_qt_q8", qt)
    quant_qt_q8.launches += 1
    return out


def quant_fold_q8_plain(bs: tuple[torch.Tensor, ...], s_qt: torch.Tensor,
                        idx: torch.Tensor
                        ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """Plain version of ``quant_fold_q8``: the selected row scales of
    ``Q^T`` folded into each ``b``, then ``quant_rows``."""
    s_sel = s_qt[:, 0][idx.long()]                    # (..., r)
    return tuple(quant_rows(b.float() * s_sel[..., None, :]) for b in bs)


def _check_fold(bs: tuple[torch.Tensor, ...], s_qt: torch.Tensor,
                idx: torch.Tensor) -> None:
    if len(bs) not in (1, 2) or bs[0].dim() < 2 \
            or any(tuple(b.shape) != tuple(bs[0].shape) for b in bs):
        raise ValueError(f"quant_fold_q8: one or two (..., m, r) operands of "
                         f"one shape, got {[tuple(b.shape) for b in bs]}")
    *batch, _, r = bs[0].shape
    for i, b in enumerate(bs, 1):
        if b.dtype != torch.float32:
            raise TypeError(f"quant_fold_q8 b{i}: expected torch.float32, "
                            f"got {b.dtype}")
    if s_qt.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"quant_fold_q8: expected fp32 scales and int32 "
                        f"indices, got {s_qt.dtype} and {idx.dtype}")
    if s_qt.dim() != 2 or s_qt.shape[1] != 1 \
            or tuple(idx.shape) != (*batch, r):
        raise ValueError(f"quant_fold_q8: scales {tuple(s_qt.shape)} and "
                         f"idx {tuple(idx.shape)} do not fit b "
                         f"{tuple(bs[0].shape)}")


def quant_fold_q8(bs: tuple[torch.Tensor, ...], s_qt: torch.Tensor,
                  idx: torch.Tensor
                  ) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """``bs``: one or two fp32 (..., m, r); ``s_qt``: the (n, 1) row scales
    of ``Q^T``; ``idx``: (..., r) int32. Returns ``((codes, scales), ...)``,
    each (..., m, r) int8 with (..., m, 1) fp32 row scales, in one launch.
    On the card an index outside [0, n) reads as a zero row of ``Q^T``
    (its scale ``F32_TINY``)."""
    _check_fold(bs, s_qt, idx)
    if cuda_lib.same_device(*bs, s_qt, idx).type == "cpu":
        return quant_fold_q8_plain(bs, s_qt, idx)
    for i, b in enumerate(bs, 1):
        cuda_lib.require_cuda(f"quant_fold_q8 b{i}", b, torch.float32)
    cuda_lib.require_cuda("quant_fold_q8 s_qt", s_qt, torch.float32)
    cuda_lib.require_cuda("quant_fold_q8 idx", idx, torch.int32)
    *batch, m, r = bs[0].shape
    codes = [torch.empty(b.shape, dtype=torch.int8, device=b.device)
             for b in bs]
    scales = [torch.empty((*batch, m, 1), dtype=torch.float32,
                          device=b.device) for b in bs]
    rows = bs[0].numel() // r if r else 0
    two = len(bs) == 2
    rc = cuda_lib.library().repro_quant_fold_q8(
        bs[0].data_ptr(), bs[1].data_ptr() if two else None,
        s_qt.data_ptr(), idx.data_ptr(), codes[0].data_ptr(),
        codes[1].data_ptr() if two else None, scales[0].data_ptr(),
        scales[1].data_ptr() if two else None, rows, m, r, s_qt.shape[0],
        cuda_lib.stream(s_qt))
    cuda_lib.check(rc, "quant_fold_q8")
    quant_fold_q8.launches += 1
    return tuple(zip(codes, scales))


quantize_ef.launches = 0
quant_rows_q8.launches = 0
quant_cols_q8t.launches = 0
quant_qt_q8.launches = 0
quant_fold_q8.launches = 0


def dequant_add_ef(g: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``G + dequant(q, scale)`` fused; a new tensor in G's dtype."""
    dev = cuda_lib.same_device(g, q, scale)
    if dev.type == "cpu":
        return dequant_add_ef_plain(g, q, scale)
    cuda_lib.require_cuda("dequant_add_ef g", g, torch.float32)
    cuda_lib.require_cuda("dequant_add_ef q", q, torch.int8, g.shape)
    cuda_lib.require_cuda("dequant_add_ef scale", scale, torch.float32,
                          (*g.shape[:-1], 1))
    n = g.shape[-1]
    rows = g.numel() // n if n else 0
    if rows >= 2**31:
        raise ValueError(f"dequant_add_ef: {rows} rows exceed the grid")
    out = torch.empty_like(g)
    rc = cuda_lib.library().repro_dequant_add_ef(
        g.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n,
        cuda_lib.stream(g))
    cuda_lib.check(rc, "dequant_add_ef")
    dequant_add_ef.launches += 1
    return out


dequant_add_ef.launches = 0
