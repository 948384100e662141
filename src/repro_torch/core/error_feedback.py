"""Quantized error-feedback buffers (paper §2.4; MicroAdam-style).

The EF buffer stores the low-rank projection residual ``Xi = G - g Q_r^T``
and is re-added to the next gradient. DCT-AdamW stores it in 8-bit with a
per-row fp32 scale: symmetric linear quantization ``q = round(x / s)``,
``s = max(max|row| / 127, F32_TINY)``, per (..., m) row of an (..., m, n)
matrix, broadcasting over leading stacked axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.lowp import q8_scale


class QuantizedBuffer(NamedTuple):
    """int8 payload + per-row scale; together a lossy fp tensor."""

    q: torch.Tensor          # (..., m, n) int8
    scale: torch.Tensor      # (..., m, 1) fp32


def quantize_q8(x: torch.Tensor) -> QuantizedBuffer:
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # max(amax/127, tiny): a subnormal row would underflow amax/127 to 0.0
    # and x / 0 would poison the payload with NaNs (kernels/lowp.py)
    scale = q8_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedBuffer(q=q, scale=scale)


def dequantize_q8(buf: QuantizedBuffer, dtype=torch.float32) -> torch.Tensor:
    return (buf.q.float() * buf.scale).to(dtype)


def zeros_q8(shape, batch_shape=(), device=None) -> QuantizedBuffer:
    full = tuple(batch_shape) + tuple(shape)
    return QuantizedBuffer(
        q=torch.zeros(full, dtype=torch.int8, device=device),
        scale=torch.ones(full[:-1] + (1,), dtype=torch.float32, device=device),
    )
