"""Fused dual column-gather back-projection:
``(b1 @ Q^T[idx, :], b2 @ Q^T[idx, :])``.

The projected-Adam step back-projects both the descent direction
``u @ Q_r^T`` and the residual reconstruction ``g_low @ Q_r^T`` through the
same selected columns every step. Both products come from one gather of the
selected rows of ``Q^T``, and the gathered ``(r, n)`` factor never exists in
device memory.

On a CUDA tensor ``colgather_matmul_dual`` launches the kernel of
``csrc/colgather_matmul.cu`` (replacing
``repro/kernels/colgather_matmul.py::_kernel_dual``; bound by the fp32 FMA
rate — see the source note) or raises. On a CPU tensor it runs
``colgather_matmul_dual_plain``. ``qt`` must be a contiguous ``Q^T``, not a
transposed view of ``Q``: the kernel reads its rows from ``data_ptr()``.

The single-operand ``colgather_matmul`` (no error feedback) is not yet
ported.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import check_compute_dtype


def colgather_matmul_dual_plain(b1: torch.Tensor, b2: torch.Tensor,
                                qt: torch.Tensor, idx: torch.Tensor,
                                out_dtype=None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    gathered = qt[idx.long()].float()                   # (..., r, n)
    dt = out_dtype or b1.dtype
    return (b1.float() @ gathered).to(dt), (b2.float() @ gathered).to(dt)


def colgather_matmul_dual(b1: torch.Tensor, b2: torch.Tensor,
                          qt: torch.Tensor, idx: torch.Tensor, *,
                          out_dtype=None, compute_dtype: str = "fp32"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``b1``, ``b2``: (..., m, r); ``qt``: Q^T (n, n); ``idx``: (..., r)
    int32 per layer. Returns two (..., m, n)."""
    check_compute_dtype(compute_dtype)
    *batch, m, r = b1.shape
    n = qt.shape[-1]
    if tuple(b2.shape) != tuple(b1.shape) or tuple(qt.shape) != (n, n) \
            or tuple(idx.shape) != (*batch, r):
        raise ValueError(f"colgather_matmul_dual: shapes b1 {tuple(b1.shape)} "
                         f"b2 {tuple(b2.shape)} qt {tuple(qt.shape)} "
                         f"idx {tuple(idx.shape)} do not fit")
    if cuda_lib.same_device(b1, b2, qt, idx).type == "cpu":
        return colgather_matmul_dual_plain(b1, b2, qt, idx, out_dtype)
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError("colgather_matmul_dual: only fp32 is ported")
    cuda_lib.require_cuda("colgather_matmul_dual b1", b1, torch.float32)
    cuda_lib.require_cuda("colgather_matmul_dual b2", b2, torch.float32)
    cuda_lib.require_cuda("colgather_matmul_dual qt", qt, torch.float32)
    cuda_lib.require_cuda("colgather_matmul_dual idx", idx, torch.int32)
    nb = b1.numel() // (m * r) if m * r else 0
    if nb >= 2**16 or m >= 2**31 or n >= 2**31:
        raise ValueError(f"colgather_matmul_dual: shape {tuple(b1.shape)} "
                         f"exceeds the grid")
    o1 = torch.empty((*batch, m, n), dtype=torch.float32, device=b1.device)
    o2 = torch.empty_like(o1)
    rc = cuda_lib.library().repro_colgather_matmul_dual(
        b1.data_ptr(), b2.data_ptr(), qt.data_ptr(), idx.data_ptr(),
        o1.data_ptr(), o2.data_ptr(), nb, m, r, n, cuda_lib.stream(b1))
    cuda_lib.check(rc, "colgather_matmul_dual")
    colgather_matmul_dual.launches += 1
    return o1, o2


colgather_matmul_dual.launches = 0
