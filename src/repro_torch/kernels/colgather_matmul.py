"""Column-gather back-projection: ``b @ Q^T[idx, :]``, for one operand or
two.

* ``colgather_matmul(b, qt, idx)`` — one back-projection: subspace Muon's
  update ``o @ Q_r^T``.
* ``colgather_matmul_dual(b1, b2, qt, idx)`` — the projected-Adam step's
  descent direction ``u @ Q_r^T`` and residual reconstruction
  ``g_low @ Q_r^T`` (and Trion's update and EF reconstruction) from one
  gather of the selected rows of ``Q^T``.

The gathered ``(r, n)`` factor never exists in device memory. On CUDA
tensors each wrapper launches its instance of the kernel template of
``csrc/colgather_matmul.cu`` (replacing
``repro/kernels/colgather_matmul.py::_kernel`` and ``::_kernel_dual``; bound
by the fp32 FMA rate — see the source note) or raises. On CPU tensors they
run ``colgather_matmul_plain`` / ``colgather_matmul_dual_plain``. ``qt`` must
be a contiguous ``Q^T``, not a transposed view of ``Q``: the kernel reads its
rows from ``data_ptr()``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import check_compute_dtype


def colgather_matmul_plain(b: torch.Tensor, qt: torch.Tensor,
                           idx: torch.Tensor, out_dtype=None) -> torch.Tensor:
    return (b.float() @ qt[idx.long()].float()).to(out_dtype or b.dtype)


def _check_shapes(name: str, bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
                  idx: torch.Tensor) -> tuple[list[int], int, int, int]:
    """Returns (batch, m, r, n); raises on operands that do not fit."""
    *batch, m, r = bs[0].shape
    n = qt.shape[-1]
    if any(tuple(b.shape) != tuple(bs[0].shape) for b in bs[1:]) \
            or tuple(qt.shape) != (n, n) or tuple(idx.shape) != (*batch, r):
        raise ValueError(f"{name}: shapes {[tuple(b.shape) for b in bs]} "
                         f"qt {tuple(qt.shape)} idx {tuple(idx.shape)} do "
                         f"not fit")
    return batch, m, r, n


def _launch_args(name: str, bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
                 idx: torch.Tensor, m: int, r: int, n: int, out_dtype) -> int:
    """The checks before a launch; returns the collapsed batch size."""
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError(f"{name}: only fp32 is ported")
    for i, b in enumerate(bs, 1):
        cuda_lib.require_cuda(f"{name} b{i}", b, torch.float32)
    cuda_lib.require_cuda(f"{name} qt", qt, torch.float32)
    cuda_lib.require_cuda(f"{name} idx", idx, torch.int32)
    nb = bs[0].numel() // (m * r) if m * r else 0
    if nb >= 2**16 or m >= 2**31 or n >= 2**31:
        raise ValueError(f"{name}: shape {tuple(bs[0].shape)} exceeds the "
                         f"grid")
    return nb


def colgather_matmul(b: torch.Tensor, qt: torch.Tensor, idx: torch.Tensor, *,
                     out_dtype=None, compute_dtype: str = "fp32"
                     ) -> torch.Tensor:
    """``b``: (..., m, r); ``qt``: Q^T (n, n); ``idx``: (..., r) int32 per
    layer. Returns (..., m, n)."""
    check_compute_dtype(compute_dtype)
    batch, m, r, n = _check_shapes("colgather_matmul", (b,), qt, idx)
    if cuda_lib.same_device(b, qt, idx).type == "cpu":
        return colgather_matmul_plain(b, qt, idx, out_dtype)
    nb = _launch_args("colgather_matmul", (b,), qt, idx, m, r, n, out_dtype)
    out = torch.empty((*batch, m, n), dtype=torch.float32, device=b.device)
    rc = cuda_lib.library().repro_colgather_matmul(
        b.data_ptr(), qt.data_ptr(), idx.data_ptr(), out.data_ptr(), nb, m, r,
        n, cuda_lib.stream(b))
    cuda_lib.check(rc, "colgather_matmul")
    colgather_matmul.launches += 1
    return out


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
    batch, m, r, n = _check_shapes("colgather_matmul_dual", (b1, b2), qt, idx)
    if cuda_lib.same_device(b1, b2, qt, idx).type == "cpu":
        return colgather_matmul_dual_plain(b1, b2, qt, idx, out_dtype)
    nb = _launch_args("colgather_matmul_dual", (b1, b2), qt, idx, m, r, n,
                      out_dtype)
    o1 = torch.empty((*batch, m, n), dtype=torch.float32, device=b1.device)
    o2 = torch.empty_like(o1)
    rc = cuda_lib.library().repro_colgather_matmul_dual(
        b1.data_ptr(), b2.data_ptr(), qt.data_ptr(), idx.data_ptr(),
        o1.data_ptr(), o2.data_ptr(), nb, m, r, n, cuda_lib.stream(b1))
    cuda_lib.check(rc, "colgather_matmul_dual")
    colgather_matmul_dual.launches += 1
    return o1, o2


colgather_matmul.launches = 0
colgather_matmul_dual.launches = 0
