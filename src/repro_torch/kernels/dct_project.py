"""Fused basis projection: ``S = G @ Q`` plus per-column squared norms.

One pass over ``G`` gives both the similarity matrix and the column ranking
statistic ``norms[j] = sum_i S[i, j]^2`` of the dynamic column selection, so
the selection needs no second read of ``S``. Nothing in it is DCT-specific:
``Q`` is any shared ``(n, n)`` basis.

``compute_dtype`` selects the precision (``kernels/lowp.py``): "fp32",
"bf16" (operands rounded to bf16, fp32 accumulation) or "int8" (``G``
quantized per row, ``Q`` per column, exact integer accumulation, the scales
in the epilogue; the norms are those of the dequantized ``S``).

On CUDA tensors ``dct_project`` launches the matching kernel of
``csrc/dct_project.cu`` (replacing ``repro/kernels/dct_project.py::_kernel``
and ``::_kernel_q8``; see the source note for what bounds each) and its
fixed-order row-block reduction of the norms, or raises; each precision has
a launcher with its own launch count (``dct_project``, ``dct_project_bf16``,
``dct_project_q8``). For int8 the operands are quantized by two kernels of
``csrc/quant_ef.cu``, one launch each and counted on their own names:
``quant_rows_q8`` (G per row) and ``quant_cols_q8t`` (Q per column, its
codes written as ``Q^T``'s, the layout the int8 kernel reads); codes and
scales equal ``lowp.quant_rows`` / ``quant_cols``' bit for bit.
``dct_project_q8t`` is the int8 launcher on ``Q^T``'s codes, the one the
main path calls; ``dct_project_q8`` takes ``Q``'s codes (the plain
version's arguments) and transposes them first. On CPU tensors every entry
point runs its plain version. Leading stacked-layer axes of ``G`` become
the kernel's batch grid dimension: every layer is projected in one launch
against the one shared basis.

``partials=True`` also returns the norms' per-row-block partial sums
``(..., blocks, n)``, block ``b`` summing the squares of rows
``[BLOCK_ROWS * b, BLOCK_ROWS * (b + 1))``: on the card the kernel's own
first-stage buffer, whose fixed-order sum (block 0, 1, ...) is the norms;
on the CPU the plain version's per-block sums. ZeRO-1 gathers them across
the row shards to complete the selection statistic
(``core.selection.allsum_row_blocks``).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import (check_compute_dtype, check_q8_depth, int_matmul,
                   lowp_matmul, quant_cols, quant_rows)
from .quant_ef import quant_cols_q8t, quant_rows_q8


# rows of G per CTA of csrc/dct_project.cu (its BM): the row blocks of the
# partial-norm buffer; the wrapper checks the library's value
BLOCK_ROWS = 128


def _with_norms(s32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return s32, (s32 * s32).sum(dim=-2)


def row_block_partials(s32: torch.Tensor) -> torch.Tensor:
    """The plain per-row-block partial norms of ``S`` (..., m, n):
    (..., ceil(m / BLOCK_ROWS), n)."""
    *batch, m, n = s32.shape
    blocks = -(-m // BLOCK_ROWS)
    sq = s32 * s32
    if blocks * BLOCK_ROWS != m:
        sq = torch.cat([sq, sq.new_zeros((*batch, blocks * BLOCK_ROWS - m,
                                          n))], dim=-2)
    return sq.view(*batch, blocks, BLOCK_ROWS, n).sum(dim=-2)


def dct_project_q8_plain(gq: torch.Tensor, sg: torch.Tensor,
                         qq: torch.Tensor, sq: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 product of quantized operands: ``gq`` (..., m, n) int8 with
    row scales ``sg`` (..., m, 1), ``qq`` (n, n) int8 with column scales
    ``sq`` (1, n). ``S = (float(sum) * sg) * sq`` in that order."""
    return _with_norms(int_matmul(gq, qq) * sg * sq)


def dct_project_q8t_plain(gq: torch.Tensor, sg: torch.Tensor,
                          qtq: torch.Tensor, sq: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dct_project_q8_plain`` on ``Q^T``'s codes: ``qtq[j, k] ==
    qq[k, j]``."""
    return dct_project_q8_plain(gq, sg, qtq.mT, sq)


def dct_project_plain(g: torch.Tensor, q: torch.Tensor, out_dtype=None,
                      compute_dtype: str = "fp32"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    if compute_dtype == "int8":
        s32, norms = dct_project_q8_plain(*quant_rows(g), *quant_cols(q))
    else:
        s32, norms = _with_norms(lowp_matmul(g, q, compute_dtype))
    return s32.to(out_dtype or g.dtype), norms


def _launch_shape(name: str, g: torch.Tensor) -> tuple[list[int], int, int, int]:
    """(batch, nb, m, n) of a CUDA launch; raises past the grid."""
    *batch, m, n = g.shape
    nb = g.numel() // (m * n) if m * n else 0
    if nb >= 2**16 or m >= 2**31 or n >= 2**31:
        raise ValueError(f"{name}: shape {tuple(g.shape)} exceeds the grid")
    return batch, nb, m, n


def _outputs(g: torch.Tensor, batch, nb: int, m: int, n: int):
    """S, the norms and the partial-norm buffer ``(*batch, blocks, n)`` of
    a launch."""
    if cuda_lib.library().repro_dct_project_block_rows() != BLOCK_ROWS:
        raise RuntimeError("dct_project: the library's row block is not "
                           f"BLOCK_ROWS = {BLOCK_ROWS}")
    row_blocks = -(-m // BLOCK_ROWS)
    s = torch.empty((*batch, m, n), dtype=torch.float32, device=g.device)
    norms = torch.empty((*batch, n), dtype=torch.float32, device=g.device)
    partial = torch.empty((*batch, row_blocks, n), dtype=torch.float32,
                          device=g.device)
    return s, norms, partial


def _launch_f32(name: str, g: torch.Tensor, q: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fp32 kernel, or its bf16 operand variant (``name``): S, the
    norms and the partials."""
    cuda_lib.require_cuda(f"{name} g", g, torch.float32)
    cuda_lib.require_cuda(f"{name} q", q, torch.float32)
    batch, nb, m, n = _launch_shape(name, g)
    s, norms, partial = _outputs(g, batch, nb, m, n)
    rc = getattr(cuda_lib.library(), f"repro_{name}")(
        g.data_ptr(), q.data_ptr(), s.data_ptr(), partial.data_ptr(),
        norms.data_ptr(), nb, m, n, cuda_lib.stream(g))
    cuda_lib.check(rc, name)
    return s, norms, partial


def dct_project_bf16(g: torch.Tensor, q: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dct_project`` with both operands rounded to bf16: fp32 ``(S,
    norms)``."""
    if cuda_lib.same_device(g, q).type == "cpu":
        return dct_project_plain(g, q, torch.float32, "bf16")
    return _dct_project_bf16(g, q)[:2]


def _dct_project_bf16(g: torch.Tensor, q: torch.Tensor):
    out = _launch_f32("dct_project_bf16", g, q)
    dct_project_bf16.launches += 1
    return out


def _check_q8(name: str, gq: torch.Tensor, sg: torch.Tensor,
              qq: torch.Tensor, sq: torch.Tensor) -> torch.device:
    """Shapes, depth and device of an int8 product's operands."""
    *_, m, n = gq.shape
    if tuple(qq.shape) != (n, n) or tuple(sg.shape) != (*gq.shape[:-1], 1) \
            or tuple(sq.shape) != (1, n):
        raise ValueError(f"{name}: shapes gq {tuple(gq.shape)} sg "
                         f"{tuple(sg.shape)} codes of Q {tuple(qq.shape)} sq "
                         f"{tuple(sq.shape)} do not fit")
    check_q8_depth(n)
    return cuda_lib.same_device(gq, sg, qq, sq)


def dct_project_q8t(gq: torch.Tensor, sg: torch.Tensor, qtq: torch.Tensor,
                    sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 product on ``Q^T``'s codes (``dct_project_q8t_plain``'s
    arguments; ``quant_cols_q8t`` makes them): fp32 ``(S, norms)``, S equal
    to the plain version's bit for bit. Counted as ``dct_project_q8``."""
    if _check_q8("dct_project_q8t", gq, sg, qtq, sq).type == "cpu":
        return dct_project_q8t_plain(gq, sg, qtq, sq)
    return _dct_project_q8t(gq, sg, qtq, sq)[:2]


def _dct_project_q8t(gq, sg, qtq, sq):
    """The int8 launch: S, the norms and the partials."""
    cuda_lib.require_cuda("dct_project_q8t gq", gq, torch.int8)
    cuda_lib.require_cuda("dct_project_q8t sg", sg, torch.float32)
    cuda_lib.require_cuda("dct_project_q8t qtq", qtq, torch.int8)
    cuda_lib.require_cuda("dct_project_q8t sq", sq, torch.float32)
    batch, nb, m, n = _launch_shape("dct_project_q8t", gq)
    s, norms, partial = _outputs(gq, batch, nb, m, n)
    rc = cuda_lib.library().repro_dct_project_q8t(
        gq.data_ptr(), qtq.data_ptr(), sg.data_ptr(), sq.data_ptr(),
        s.data_ptr(), partial.data_ptr(), norms.data_ptr(), nb, m, n,
        cuda_lib.stream(gq))
    cuda_lib.check(rc, "dct_project_q8t")
    dct_project_q8.launches += 1
    return s, norms, partial


def dct_project_q8(gq: torch.Tensor, sg: torch.Tensor, qq: torch.Tensor,
                   sq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 product of quantized operands (``dct_project_q8_plain``'s
    arguments): fp32 ``(S, norms)``, S equal to the plain version's bit for
    bit. On the card ``qq`` is transposed (one copy) for
    ``dct_project_q8t``."""
    if _check_q8("dct_project_q8", gq, sg, qq, sq).type == "cpu":
        return dct_project_q8_plain(gq, sg, qq, sq)
    cuda_lib.require_cuda("dct_project_q8 qq", qq, torch.int8)
    return dct_project_q8t(gq, sg, qq.mT.contiguous(), sq)


def dct_project(g: torch.Tensor, q: torch.Tensor, *, out_dtype=None,
                compute_dtype: str = "fp32", partials: bool = False):
    """Returns ``(S, norms)``: ``S = G @ Q`` (..., m, n) and fp32
    squared-l2 column norms (..., n); with ``partials`` also the partial
    norms (..., blocks, n). ``g``: (..., m, n); ``q``: (n, n)."""
    check_compute_dtype(compute_dtype)
    *_, m, n = g.shape
    if tuple(q.shape) != (n, n):
        raise ValueError(f"dct_project: basis {tuple(q.shape)} does not fit "
                         f"G {tuple(g.shape)}")
    if cuda_lib.same_device(g, q).type == "cpu":
        out = dct_project_plain(g, q, out_dtype, compute_dtype)
        return (*out, row_block_partials(out[0].float())) if partials \
            else out
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError("dct_project: only fp32 S is ported")
    if compute_dtype == "int8":
        cuda_lib.require_cuda("dct_project g", g, torch.float32)
        check_q8_depth(n)
        out = _dct_project_q8t(*quant_rows_q8(g), *quant_cols_q8t(q))
    elif compute_dtype == "bf16":
        out = _dct_project_bf16(g, q)
    else:
        out = _launch_f32("dct_project", g, q)
        dct_project.launches += 1
    return out if partials else out[:2]


dct_project.launches = 0
dct_project_bf16.launches = 0
dct_project_q8.launches = 0
