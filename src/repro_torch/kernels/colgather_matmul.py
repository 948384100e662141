"""Column-gather back-projection: ``b @ Q^T[idx, :]``, for one operand or
two.

* ``colgather_matmul(b, qt, idx)`` — one back-projection: subspace Muon's
  update ``o @ Q_r^T``, and DCT-AdamW's descent direction when it keeps no
  residual.
* ``colgather_matmul_dual(b1, b2, qt, idx)`` — the projected-Adam step's
  descent direction ``u @ Q_r^T`` and residual reconstruction
  ``g_low @ Q_r^T`` (and Trion's update and EF reconstruction) from one
  gather of the selected rows of ``Q^T``.

``compute_dtype`` selects the precision (``kernels/lowp.py``): "fp32",
"bf16" (operands rounded to bf16, fp32 accumulation) or "int8" (``Q^T``
quantized per row, the selected rows' scales folded into each ``b`` before
its own per-row quantization, exact integer accumulation, one scale per
output row).

The gathered ``(r, n)`` factor never exists in device memory. On CUDA
tensors each wrapper launches its instance of the kernel templates of
``csrc/colgather_matmul.cu`` (replacing
``repro/kernels/colgather_matmul.py::_kernel``, ``::_kernel_dual``,
``::_kernel_q8`` and ``::_kernel_dual_q8``: fp32 on the SIMT cores, bf16 and
int8 on the tensor cores; see the source note for what bounds each) or
raises; each precision has launchers with launch counts of their own
(``colgather_matmul[_dual]``, ``..._bf16``, ``..._q8``). For int8 the
operands are quantized outside the product, as in the JAX package, by two
kernels of ``csrc/quant_ef.cu`` (``quantize_operands``: ``quant_qt_q8``
for ``Q^T``, ``quant_fold_q8`` for every ``b`` of the call), each counted
on its own name. On CPU tensors every entry point runs its plain version.
``qt`` must be a contiguous ``Q^T``, not a transposed view of ``Q``: the
kernel reads its rows from ``data_ptr()``. On the card an index outside
[0, n) gathers a zero row of ``Q^T``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import (check_compute_dtype, check_q8_depth, int_matmul,
                   lowp_gather_matmul, quant_rows)
from .quant_ef import quant_fold_q8, quant_fold_q8_plain, quant_qt_q8


def colgather_matmul_plain(b: torch.Tensor, qt: torch.Tensor,
                           idx: torch.Tensor, out_dtype=None,
                           compute_dtype: str = "fp32") -> torch.Tensor:
    (o,) = lowp_gather_matmul((b,), qt, idx, compute_dtype)
    return o.to(out_dtype or b.dtype)


def colgather_matmul_dual_plain(b1: torch.Tensor, b2: torch.Tensor,
                                qt: torch.Tensor, idx: torch.Tensor,
                                out_dtype=None, compute_dtype: str = "fp32"
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    o1, o2 = lowp_gather_matmul((b1, b2), qt, idx, compute_dtype)
    dt = out_dtype or b1.dtype
    return o1.to(dt), o2.to(dt)


def colgather_q8_plain(bqs: tuple[tuple[torch.Tensor, torch.Tensor], ...],
                       qt_q: torch.Tensor, idx: torch.Tensor
                       ) -> tuple[torch.Tensor, ...]:
    """The int8 products of quantized operands: each ``(bq, sb)`` is an int8
    (..., m, r) factor with row scales (..., m, 1), ``qt_q`` the int8 codes
    of ``Q^T`` (n, n). ``float(sum) * sb`` per operand."""
    gathered = qt_q[idx.long()]
    return tuple(int_matmul(bq, gathered) * sb for bq, sb in bqs)


def quantize_operands_plain(bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
                            idx: torch.Tensor):
    """``Q^T`` quantized per row, its selected rows' scales folded into each
    ``b`` and each ``b`` quantized per row: ``(((bq, sb), ...), qt_q)``."""
    qt_q, s_qt = quant_rows(qt)
    return quant_fold_q8_plain(bs, s_qt, idx), qt_q


def quantize_operands(bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
                      idx: torch.Tensor):
    """``quantize_operands_plain``'s codes and scales bit for bit; on the
    card two launches (``quant_qt_q8``, ``quant_fold_q8``)."""
    qt_q, s_qt = quant_qt_q8(qt)
    return quant_fold_q8(bs, s_qt, idx), qt_q


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


def _launch(name: str, bs: tuple[torch.Tensor, ...], qt: torch.Tensor,
            idx: torch.Tensor, scales: tuple[torch.Tensor, ...] = ()
            ) -> tuple[torch.Tensor, ...]:
    """Check the operands of ``repro_<name>`` and launch it: fp32 ``bs`` and
    ``qt``, or int8 ones with their row ``scales``. Returns the outputs."""
    batch, m, r, n = _check_shapes(name, bs, qt, idx)
    dtype = torch.int8 if scales else torch.float32
    for i, b in enumerate(bs, 1):
        cuda_lib.require_cuda(f"{name} b{i}", b, dtype)
    for i, s in enumerate(scales, 1):
        cuda_lib.require_cuda(f"{name} s{i}", s, torch.float32, (*batch, m, 1))
    cuda_lib.require_cuda(f"{name} qt", qt, dtype)
    cuda_lib.require_cuda(f"{name} idx", idx, torch.int32)
    nb = bs[0].numel() // (m * r) if m * r else 0
    if nb >= 2**16 or m >= 2**31 or n >= 2**31:
        raise ValueError(f"{name}: shape {tuple(bs[0].shape)} exceeds the "
                         f"grid")
    outs = tuple(torch.empty((*batch, m, n), dtype=torch.float32,
                             device=qt.device) for _ in bs)
    operands = [p for pair in zip(bs, scales) for p in pair] if scales \
        else list(bs)
    rc = getattr(cuda_lib.library(), f"repro_{name}")(
        *(t.data_ptr() for t in operands), qt.data_ptr(), idx.data_ptr(),
        *(o.data_ptr() for o in outs), nb, m, r, n, cuda_lib.stream(qt))
    cuda_lib.check(rc, name)
    return outs


def _check_q8(name: str, bqs: tuple[torch.Tensor, ...],
              scales: tuple[torch.Tensor, ...], qt_q: torch.Tensor,
              idx: torch.Tensor) -> None:
    """The int8 operands' shapes and dtypes, on every device."""
    batch, m, r, _ = _check_shapes(name, bqs, qt_q, idx)
    check_q8_depth(r)
    for t, dtype in [*((b, torch.int8) for b in bqs),
                     *((s, torch.float32) for s in scales),
                     (qt_q, torch.int8), (idx, torch.int32)]:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if any(tuple(s.shape) != (*batch, m, 1) for s in scales):
        raise ValueError(f"{name}: scales {[tuple(s.shape) for s in scales]}"
                         f" do not fit {(*batch, m, 1)}")


def colgather_matmul_q8(bq: torch.Tensor, sb: torch.Tensor,
                        qt_q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The int8 back-projection of quantized operands
    (``colgather_q8_plain``'s), bit-equal to the plain version."""
    _check_q8("colgather_matmul_q8", (bq,), (sb,), qt_q, idx)
    if cuda_lib.same_device(bq, sb, qt_q, idx).type == "cpu":
        return colgather_q8_plain(((bq, sb),), qt_q, idx)[0]
    (out,) = _launch("colgather_matmul_q8", (bq,), qt_q, idx, (sb,))
    colgather_matmul_q8.launches += 1
    return out


def colgather_matmul_dual_q8(b1q: torch.Tensor, s1: torch.Tensor,
                             b2q: torch.Tensor, s2: torch.Tensor,
                             qt_q: torch.Tensor, idx: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both int8 back-projections from one gather of the int8 rows."""
    _check_q8("colgather_matmul_dual_q8", (b1q, b2q), (s1, s2), qt_q, idx)
    if cuda_lib.same_device(b1q, s1, b2q, s2, qt_q, idx).type == "cpu":
        return colgather_q8_plain(((b1q, s1), (b2q, s2)), qt_q, idx)
    outs = _launch("colgather_matmul_dual_q8", (b1q, b2q), qt_q, idx,
                   (s1, s2))
    colgather_matmul_dual_q8.launches += 1
    return outs


def _check_out_dtype(name: str, out_dtype) -> None:
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError(f"{name}: only fp32 outputs are ported")


def colgather_matmul_bf16(b: torch.Tensor, qt: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """``colgather_matmul`` with the operands rounded to bf16."""
    if cuda_lib.same_device(b, qt, idx).type == "cpu":
        return colgather_matmul_plain(b, qt, idx, torch.float32, "bf16")
    (out,) = _launch("colgather_matmul_bf16", (b,), qt, idx)
    colgather_matmul_bf16.launches += 1
    return out


def colgather_matmul_dual_bf16(b1: torch.Tensor, b2: torch.Tensor,
                               qt: torch.Tensor, idx: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``colgather_matmul_dual`` with the operands rounded to bf16."""
    if cuda_lib.same_device(b1, b2, qt, idx).type == "cpu":
        return colgather_matmul_dual_plain(b1, b2, qt, idx, torch.float32,
                                           "bf16")
    outs = _launch("colgather_matmul_dual_bf16", (b1, b2), qt, idx)
    colgather_matmul_dual_bf16.launches += 1
    return outs


def colgather_matmul(b: torch.Tensor, qt: torch.Tensor, idx: torch.Tensor, *,
                     out_dtype=None, compute_dtype: str = "fp32"
                     ) -> torch.Tensor:
    """``b``: (..., m, r); ``qt``: Q^T (n, n); ``idx``: (..., r) int32 per
    layer. Returns (..., m, n)."""
    check_compute_dtype(compute_dtype)
    _check_shapes("colgather_matmul", (b,), qt, idx)
    if cuda_lib.same_device(b, qt, idx).type == "cpu":
        return colgather_matmul_plain(b, qt, idx, out_dtype, compute_dtype)
    _check_out_dtype("colgather_matmul", out_dtype)
    if compute_dtype == "int8":
        cuda_lib.require_cuda("colgather_matmul b1", b, torch.float32)
        ((bq, sb),), qt_q = quantize_operands((b,), qt, idx)
        return colgather_matmul_q8(bq, sb, qt_q, idx)
    if compute_dtype == "bf16":
        return colgather_matmul_bf16(b, qt, idx)
    (out,) = _launch("colgather_matmul", (b,), qt, idx)
    colgather_matmul.launches += 1
    return out


def colgather_matmul_dual(b1: torch.Tensor, b2: torch.Tensor,
                          qt: torch.Tensor, idx: torch.Tensor, *,
                          out_dtype=None, compute_dtype: str = "fp32"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``b1``, ``b2``: (..., m, r); ``qt``: Q^T (n, n); ``idx``: (..., r)
    int32 per layer. Returns two (..., m, n)."""
    check_compute_dtype(compute_dtype)
    _check_shapes("colgather_matmul_dual", (b1, b2), qt, idx)
    if cuda_lib.same_device(b1, b2, qt, idx).type == "cpu":
        return colgather_matmul_dual_plain(b1, b2, qt, idx, out_dtype,
                                           compute_dtype)
    _check_out_dtype("colgather_matmul_dual", out_dtype)
    if compute_dtype == "int8":
        for i, b in enumerate((b1, b2), 1):
            cuda_lib.require_cuda(f"colgather_matmul_dual b{i}", b,
                                  torch.float32)
        ((b1q, s1), (b2q, s2)), qt_q = quantize_operands((b1, b2), qt, idx)
        return colgather_matmul_dual_q8(b1q, s1, b2q, s2, qt_q, idx)
    if compute_dtype == "bf16":
        return colgather_matmul_dual_bf16(b1, b2, qt, idx)
    outs = _launch("colgather_matmul_dual", (b1, b2), qt, idx)
    colgather_matmul_dual.launches += 1
    return outs


for _fn in (colgather_matmul, colgather_matmul_dual, colgather_matmul_bf16,
            colgather_matmul_dual_bf16, colgather_matmul_q8,
            colgather_matmul_dual_q8):
    _fn.launches = 0
