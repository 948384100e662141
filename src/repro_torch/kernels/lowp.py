"""Compute-precision vocabulary of the projection matmuls (DESIGN.md §15).

Only the fp32 path is ported; the bf16 and int8 variants of the kernels and
their mirrors are still to come, and asking for them raises.

``q8_scale`` is the one per-row int8 scale formula every error-feedback
quantizer uses (the CUDA kernel in ``csrc/quant_ef.cu`` repeats it):
``max(amax / 127, F32_TINY)``. An all-zero row quantizes to zeros under any
positive scale; the clamp exists because a *subnormal* row makes
``amax / 127`` underflow to 0 and ``x / 0`` would fill the payload with NaNs.
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
    if compute_dtype != "fp32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} is not yet ported to "
            "repro_torch; only fp32 is")
    return compute_dtype


def q8_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax -> symmetric int8 scale, clamped away from zero/subnormal.

    The divisor is a tensor, not a Python number: on CUDA, PyTorch divides
    by a Python scalar as a multiply by its reciprocal, which is 1 ulp off
    the IEEE quotient the kernel and the JAX package compute."""
    return torch.clamp_min(amax / amax.new_full((), 127.0), F32_TINY)
