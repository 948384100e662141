"""Newton–Schulz on the low-rank factor (Trion's hot loop), through the CUDA
kernels of ``csrc/newton_schulz.cu``.

One NS5 iteration on the wide-oriented factor ``X (r, m)`` (r <= m) is

    A = X X^T            ``ns_gram``  (replaces repro/kernels/newton_schulz.py::_gram_kernel)
    P = b A + c A A      (r x r) a batched ``torch.matmul``, as the JAX
                         package computes it outside Pallas
    X = a X + P X        ``ns_apply`` (replaces ::_apply_kernel)

``newton_schulz_kernel`` is the counterpart of the JAX package's
``newton_schulz_pallas``: ``core.newton_schulz``'s driver (one orientation
for the whole stack, a per-matrix Frobenius normalization with ``eps``,
``steps`` iterations, the input dtype back) with ``ns_iteration`` as its
step. Its two ``(..., r, m)`` buffers are allocated once and the iterations
ping-pong between them. Leading stacked-layer axes become the kernels' batch
grid dimension. There is no block-size knob: the tiles are the kernels'
own. The Gram kernel splits X's m columns into ranges (``ns_gram_splits``),
a CTA per range computing the 32 x 32 blocks of A on or above the diagonal
into a workspace the wrapper allocates (``ns_gram_workspace_floats``), and
a second kernel sums the ranges in a fixed order: the same bits every
time, A exactly symmetric. The apply kernel's CTA owns all r rows of a
64-column stripe of X, held in shared memory, so it reads X once.
``ns_apply_smem_bytes`` is that kernel's shared memory at a given r;
``APPLY_MAX_RANK`` (768) is the largest r whose stripe fits a block, and the
wrapper refuses a larger one on the card (``fused_step`` routes r <= 512).

On CUDA tensors ``ns_gram`` / ``ns_apply`` launch their kernel or raise; on
CPU tensors they run ``ns_gram_plain`` / ``ns_apply_plain``, whose
composition is exactly ``core.newton_schulz``'s iteration. Both kernels are
bound by the fp32 FMA rate (see the source note).
"""
from __future__ import annotations

import torch

from repro_torch.core.newton_schulz import NS_COEFFS, newton_schulz

from . import cuda_lib


# ns_apply's shared memory (csrc/newton_schulz.cu): the ring of P slices
# (2 x (128 x 16) fp32 as they arrive, 2 x 16 x 132 transposed), then X's
# (r, 64) fp32 stripe with r padded to the 16-deep slice
SMEM_PER_BLOCK = 232448                  # H100: 227 KB a block can use
_APPLY_COLS, _APPLY_SLICE = 64, 16
_APPLY_RING_BYTES = 4 * (2 * 128 * 16 + 2 * 16 * 132)


def ns_apply_smem_bytes(r: int) -> int:
    """Bytes of shared memory the apply kernel takes at rank ``r``."""
    slices = -(-r // _APPLY_SLICE)
    return _APPLY_RING_BYTES + 4 * _APPLY_COLS * _APPLY_SLICE * slices


APPLY_MAX_RANK = ((SMEM_PER_BLOCK - _APPLY_RING_BYTES)
                  // (4 * _APPLY_COLS * _APPLY_SLICE) * _APPLY_SLICE)


# ns_gram's geometry (csrc/newton_schulz.cu, namespace gram): A in 32 x 32
# blocks, macro tiles of 4 x 4 blocks; X's m columns cut into ranges of a
# multiple of the k slice, one CTA each per (layer, macro tile), at most
# GRAM_MAX_SPLITS. The wrapper cuts m into as many ranges of at least
# GRAM_SPLIT_MIN_COLS columns as give about GRAM_CTAS CTAs, 3 on each of an
# H100's 132 SMs (Trion's 24 layers at r = 128: 16 ranges, 384 CTAs)
GRAM_BLOCK, GRAM_MACRO, GRAM_SLICE = 32, 4, 16
GRAM_MAX_SPLITS = 64
GRAM_CTAS, GRAM_SPLIT_MIN_COLS = 3 * 132, 64


def _gram_tiles(r: int) -> tuple[int, int]:
    """(macro tiles on or above the diagonal, warps of a CTA) at rank r: a
    warp per two blocks on or above the diagonal of its macro tile (1, 2, 3
    or 5 at r <= 128), 8 when r > 128."""
    blocks = -(-r // GRAM_BLOCK)
    if blocks <= GRAM_MACRO:
        return 1, -(-blocks * (blocks + 1) // 4)
    n = -(-blocks // GRAM_MACRO)
    return n * (n + 1) // 2, 8


def ns_gram_splits(batch: int, r: int, m: int) -> tuple[int, int]:
    """``(splits, width)`` of the Gram kernel for ``batch`` layers of (r, m):
    ``width`` a multiple of ``GRAM_SLICE``, ``splits`` ranges of it covering
    m, none empty."""
    ctas = max(1, batch * _gram_tiles(r)[0])
    splits = max(1, min(GRAM_CTAS // ctas, m // GRAM_SPLIT_MIN_COLS,
                        GRAM_MAX_SPLITS))
    width = -(-max(m, 1) // splits)
    width = -(-width // GRAM_SLICE) * GRAM_SLICE
    return max(1, -(-m // width)), width


def ns_gram_workspace_floats(batch: int, r: int, splits: int) -> int:
    """fp32 entries of the Gram kernel's workspace: a 32 x 64 region of
    partial sums per warp, per (layer, macro tile, range)."""
    tiles, warps = _gram_tiles(r)
    return batch * tiles * splits * warps * 2 * GRAM_BLOCK * GRAM_BLOCK


def ns_gram_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, x.mT)


def ns_apply_plain(x: torch.Tensor, p: torch.Tensor, a: float,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    return torch.add(a * x, torch.matmul(p, x), out=out)


def _batch(name: str, x: torch.Tensor) -> int:
    *_, r, m = x.shape
    nb = x.numel() // (r * m) if r * m else 0
    if nb >= 2**16 or r >= 2**31 or m >= 2**31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the grid")
    return nb


def ns_gram(x: torch.Tensor) -> torch.Tensor:
    """``A = X X^T`` (..., r, r) of a wide ``x`` (..., r, m), fp32."""
    *batch, r, m = x.shape
    if x.device.type == "cpu":
        return ns_gram_plain(x)
    cuda_lib.require_cuda("ns_gram x", x, torch.float32)
    nb = _batch("ns_gram", x)
    out = torch.empty((*batch, r, r), dtype=torch.float32, device=x.device)
    splits, width = ns_gram_splits(nb, r, m)
    ws = torch.empty(ns_gram_workspace_floats(nb, r, splits),
                     dtype=torch.float32, device=x.device)
    rc = cuda_lib.library().repro_ns_gram(x.data_ptr(), out.data_ptr(),
                                          ws.data_ptr(), nb, r, m, splits,
                                          width, cuda_lib.stream(x))
    cuda_lib.check(rc, "ns_gram")
    ns_gram.launches += 1
    return out


def ns_apply(x: torch.Tensor, p: torch.Tensor, *, a: float = NS_COEFFS[0],
             out: torch.Tensor | None = None) -> torch.Tensor:
    """``a X + P X`` for ``x`` (..., r, m) and ``p`` (..., r, r), into
    ``out`` (a new tensor if None; never ``x`` itself)."""
    *batch, r, m = x.shape
    if tuple(p.shape) != (*batch, r, r):
        raise ValueError(f"ns_apply: P {tuple(p.shape)} does not fit X "
                         f"{tuple(x.shape)}")
    if out is not None and (tuple(out.shape) != tuple(x.shape)
                            or out.data_ptr() == x.data_ptr()):
        raise ValueError("ns_apply: out must be a buffer of X's shape other "
                         "than X")
    if cuda_lib.same_device(x, p).type == "cpu":
        return ns_apply_plain(x, p, a, out)
    cuda_lib.require_cuda("ns_apply x", x, torch.float32)
    cuda_lib.require_cuda("ns_apply p", p, torch.float32)
    if r > APPLY_MAX_RANK:
        raise ValueError(f"ns_apply: r = {r} exceeds the kernel's "
                         f"APPLY_MAX_RANK = {APPLY_MAX_RANK} (X's stripe must "
                         f"fit a block's shared memory)")
    if out is None:
        out = torch.empty_like(x)
    else:
        cuda_lib.require_cuda("ns_apply out", out, torch.float32)
    nb = _batch("ns_apply", x)
    rc = cuda_lib.library().repro_ns_apply(x.data_ptr(), p.data_ptr(),
                                           out.data_ptr(), a, nb, r, m,
                                           cuda_lib.stream(x))
    cuda_lib.check(rc, "ns_apply")
    ns_apply.launches += 1
    return out


ns_gram.launches = 0
ns_apply.launches = 0


def ns_iteration(x: torch.Tensor, *, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """One NS5 iteration on a wide ``x (..., r, m)``, r <= m: the gram
    launch, the (r, r) polynomial, the apply launch (into ``out``)."""
    a, b, c = NS_COEFFS
    gram = ns_gram(x)
    poly = b * gram + c * torch.matmul(gram, gram)
    return ns_apply(x, poly, a=a, out=out)


def newton_schulz_kernel(x: torch.Tensor, *, steps: int = 5,
                         eps: float = 1e-7) -> torch.Tensor:
    """Full NS orthogonalization of ``x (..., p, q)`` through the kernels:
    the counterpart of ``repro.kernels.newton_schulz.newton_schulz_pallas``.
    ``core.newton_schulz``'s driver (orientation, normalization, the two
    ping-pong buffers, the cast back) with ``ns_iteration`` as its step."""
    return newton_schulz(x, steps, eps, iteration=ns_iteration)


#: the JAX package's name of the full NS through the kernels
newton_schulz_pallas = newton_schulz_kernel
