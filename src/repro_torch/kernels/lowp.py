"""Compute-precision vocabulary of the projection matmuls (DESIGN.md §15).

``compute_dtype`` selects the precision of ``dct_project`` and
``colgather_matmul``: "fp32" (exact fp32), "bf16" (operands rounded to bf16,
fp32 accumulation) or "int8" (symmetric per-row / per-column int8 operands,
exact integer accumulation, the scales folded into an fp32 epilogue).

int8 epilogue math. The projection ``S = G @ Q`` runs as

    S[i, j] ~= ((sum_k Gq[i, k] * Qq[k, j]) * s_g[i]) * s_q[j]

with ``Gq = round(G / s_g)`` per row and ``Qq = round(Q / s_q)`` per column.
The back-projection ``O = b @ Q^T[idx, :]`` gathers *rows* of ``Q^T``, so
``Q^T`` is quantized per row once, before the gather, and the selected row
scales are folded into ``b`` before ``b``'s own per-row quantization:

    O[i, j] ~= (sum_k bq[i, k] * Qtq[idx[k], j]) * s_b[i]

Every partial sum of int8 codes is an integer of magnitude at most
``127**2 * k``, below 2**31 for every depth ``check_q8_depth`` lets
through. PyTorch has no int32 matmul on CUDA (``torch._int_mm`` is private
and shape-limited), so the plain versions here multiply the codes as fp64:
every partial sum is an integer below 2**53, so the fp64 result *is* the
exact integer sum, and its conversion to fp32 rounds that integer exactly
as the kernels' (and JAX's) ``float(int32)`` does. The CUDA kernels
accumulate in int32.

``q8_scale`` is the one per-row int8 scale formula every quantizer uses (the
CUDA kernel in ``csrc/quant_ef.cu`` repeats it): ``max(amax / 127,
F32_TINY)``. An all-zero row quantizes to zeros under any positive scale;
the clamp exists because a *subnormal* row makes ``amax / 127`` underflow to
0 and ``x / 0`` would fill the payload with NaNs.
"""
from __future__ import annotations

import torch

COMPUTE_DTYPES = ("fp32", "bf16", "int8")

#: relative Frobenius error ||lowp - fp32||_F / ||fp32||_F of each compute
#: path; fp32 is exact, which rules out TF32 on the fp32 path
LOWP_ERROR_BOUNDS = {"fp32": 0.0, "bf16": 0.01, "int8": 0.02}

#: smallest normal fp32 — the per-row scale clamp
F32_TINY = float(torch.finfo(torch.float32).tiny)


def check_compute_dtype(compute_dtype: str) -> str:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"allowed: {COMPUTE_DTYPES}")
    return compute_dtype


def check_q8_depth(k: int) -> None:
    """Raise where an int32 sum of ``k`` int8 products could overflow."""
    if not 127**2 * k < 2**31:
        raise ValueError(f"int8 contraction depth {k} could overflow the "
                         f"int32 accumulator (127**2 * k >= 2**31)")


def q8_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax -> symmetric int8 scale, clamped away from zero/subnormal.

    The divisor is a tensor, not a Python number: on CUDA, PyTorch divides
    by a Python scalar as a multiply by its reciprocal, which is 1 ulp off
    the IEEE quotient the kernel and the JAX package compute."""
    return torch.clamp_min(amax / amax.new_full((), 127.0), F32_TINY)


def _quant(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = q8_scale(xf.abs().amax(dim=dim, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last axis) symmetric int8: (..., m, n) -> int8 + (..., m, 1).
    IEEE division by a tensor, round half to even, clip at ±127."""
    return _quant(x, -1)


def quant_cols(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8: (..., k, n) -> int8 + (..., 1, n)."""
    return _quant(x, -2)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 codes, returned as fp32 (the rounding
    of ``float(int32 sum)``): an fp64 matmul, exact for every depth
    ``check_q8_depth`` allows (module docstring)."""
    check_q8_depth(a.shape[-1])
    return (a.double() @ b.double()).float()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and held in fp32: a product of
    two such values is exact in fp32."""
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# mirrors: the "off"/"fft" fused modes run these, so compute_dtype means the
# same thing under every dispatch mode
# ---------------------------------------------------------------------------
def lowp_matmul(a: torch.Tensor, b: torch.Tensor,
                compute_dtype: str) -> torch.Tensor:
    """``a (..., m, k) @ b (k, n)`` in the requested compute precision, fp32
    result. int8 equals the kernel path bit for bit (the integer sum is
    exact)."""
    check_compute_dtype(compute_dtype)
    if compute_dtype == "fp32":
        return a.float() @ b.float()
    if compute_dtype == "bf16":
        return bf16_round(a) @ bf16_round(b)
    qa, sa = quant_rows(a)
    qb, sb = quant_cols(b)
    return int_matmul(qa, qb) * sa * sb


def lowp_gather_matmul(bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
                       idx: torch.Tensor, compute_dtype: str
                       ) -> tuple[torch.Tensor, ...]:
    """``(b @ qt[idx, :] for b in bs)`` sharing one gather, in the requested
    compute precision; fp32 results. ``bs``: (..., m, r); ``qt``: (n, n);
    ``idx``: (..., r)."""
    check_compute_dtype(compute_dtype)
    idx = idx.long()
    if compute_dtype != "int8":
        cast = (lambda x: x.float()) if compute_dtype == "fp32" else bf16_round
        gathered = cast(qt[idx])
        return tuple(cast(b) @ gathered for b in bs)
    qt_q, s_qt = quant_rows(qt)                       # (n, n) i8, (n, 1)
    gathered = qt_q[idx]                              # (..., r, n) i8
    s_sel = s_qt[:, 0][idx]                           # (..., r)
    outs = []
    for b in bs:
        bq, sb = quant_rows(b.float() * s_sel[..., None, :])
        outs.append(int_matmul(bq, gathered) * sb)
    return tuple(outs)
