"""Bandwidth-bound int8 error-feedback kernels (paper §2.4).

* ``quantize_ef``    — residual (..., m, n) fp32 -> (int8 payload, per-row
  fp32 scale) in one read of the residual.
* ``dequant_add_ef`` — ``G + q * scale`` in one pass, so the dequantized fp32
  EF buffer never exists in device memory.

On a CUDA tensor each wrapper launches its kernel from ``csrc/quant_ef.cu``
(replacing ``repro/kernels/quant_ef.py::_quant_kernel`` and
``::_dequant_add_kernel``; bound by bytes — see the source note) or raises.
On a CPU tensor it runs the plain PyTorch version beside it, which is also
what the kernels are held against on the card. Leading stacked-layer axes
collapse into the row count, so a ``(layers, m, n)`` leaf is one launch.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import q8_scale


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


def quantize_ef(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., m, n) fp -> ((..., m, n) int8, (..., m, 1) fp32 row scales)."""
    if x.device.type == "cpu":
        return quantize_ef_plain(x)
    cuda_lib.require_cuda("quantize_ef x", x, torch.float32)
    *batch, m, n = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*batch, m, 1), dtype=torch.float32, device=x.device)
    rows = x.numel() // n if n else 0
    if rows >= 2**31:
        raise ValueError(f"quantize_ef: {rows} rows exceed the grid")
    rc = cuda_lib.library().repro_quantize_ef(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n,
        cuda_lib.stream(x))
    cuda_lib.check(rc, "quantize_ef")
    quantize_ef.launches += 1
    return q, scale


quantize_ef.launches = 0


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
