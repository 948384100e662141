"""Fused basis projection: ``S = G @ Q`` plus per-column squared norms.

One pass over ``G`` gives both the similarity matrix and the column ranking
statistic ``norms[j] = sum_i S[i, j]^2`` of the dynamic column selection, so
the selection needs no second read of ``S``. Nothing in it is DCT-specific:
``Q`` is any shared ``(n, n)`` basis.

On a CUDA tensor ``dct_project`` launches the fp32 SIMT GEMM of
``csrc/dct_project.cu`` (replacing ``repro/kernels/dct_project.py::_kernel``;
bound by the fp32 FMA rate — see the source note) and its fixed-order
row-block reduction of the norms, or raises. On a CPU tensor it runs
``dct_project_plain``. Leading stacked-layer axes of ``G`` become the
kernel's batch grid dimension: every layer is projected in one launch
against the one shared basis.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .lowp import check_compute_dtype


def dct_project_plain(g: torch.Tensor, q: torch.Tensor, out_dtype=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    s32 = g.float() @ q.float()
    norms = (s32 * s32).sum(dim=-2)
    return s32.to(out_dtype or g.dtype), norms


def dct_project(g: torch.Tensor, q: torch.Tensor, *, out_dtype=None,
                compute_dtype: str = "fp32"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(S, norms)``: ``S = G @ Q`` (..., m, n) and fp32
    squared-l2 column norms (..., n). ``g``: (..., m, n); ``q``: (n, n)."""
    check_compute_dtype(compute_dtype)
    *batch, m, n = g.shape
    if tuple(q.shape) != (n, n):
        raise ValueError(f"dct_project: basis {tuple(q.shape)} does not fit "
                         f"G {tuple(g.shape)}")
    if cuda_lib.same_device(g, q).type == "cpu":
        return dct_project_plain(g, q, out_dtype)
    if out_dtype not in (None, torch.float32):
        raise NotImplementedError("dct_project: only fp32 S is ported")
    cuda_lib.require_cuda("dct_project g", g, torch.float32)
    cuda_lib.require_cuda("dct_project q", q, torch.float32)
    nb = g.numel() // (m * n) if m * n else 0
    if nb >= 2**16 or m >= 2**31 or n >= 2**31:
        raise ValueError(f"dct_project: shape {tuple(g.shape)} exceeds the grid")
    lib = cuda_lib.library()
    row_blocks = -(-m // lib.repro_dct_project_block_rows())
    s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    norms = torch.empty((*batch, n), dtype=torch.float32, device=g.device)
    partial = torch.empty((nb, row_blocks, n), dtype=torch.float32,
                          device=g.device)
    rc = lib.repro_dct_project(g.data_ptr(), q.data_ptr(), s.data_ptr(),
                               partial.data_ptr(), norms.data_ptr(), nb, m, n,
                               cuda_lib.stream(g))
    cuda_lib.check(rc, "dct_project")
    dct_project.launches += 1
    return s, norms


dct_project.launches = 0
