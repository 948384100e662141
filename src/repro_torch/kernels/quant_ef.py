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

On a CUDA tensor each wrapper launches its kernel from ``csrc/quant_ef.cu``
(replacing ``repro/kernels/quant_ef.py::_quant_kernel`` and
``::_dequant_add_kernel``, and the jnp quantizers of
``repro/kernels/lowp.py``; bound by bytes — see the source note) or raises.
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


quantize_ef.launches = 0
quant_rows_q8.launches = 0
quant_cols_q8t.launches = 0


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
