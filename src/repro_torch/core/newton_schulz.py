"""Newton–Schulz orthogonalization (Muon's NS5 polynomial iteration), the
plain PyTorch counterpart of ``repro/core/newton_schulz.py``.

Pushes the singular values of a matrix toward 1, approximating ``U V^T`` from
the SVD. Trion's key trick (paper §2.3) is to run this on the **low-rank**
factor ``b_t`` (m x r) instead of the full momentum ``B_t`` (m x n), so the
Gram matrix is r x r.

Coefficients are Keller Jordan's quintic ``(3.4445, -4.7750, 2.0315)``.
Broadcasts over leading stacked axes; fp32 inside. This is also the plain
version the CUDA kernel path (``kernels/newton_schulz.py``) is held to.
"""
from __future__ import annotations

import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _ns_step(x: torch.Tensor, coeffs=NS_COEFFS, *,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One iteration on a wide ``x (..., k, m)``, k <= m, into ``out``."""
    a, b, c = coeffs
    xxt = torch.matmul(x, x.mT)
    bx_cx2 = b * xxt + c * torch.matmul(xxt, xxt)
    return torch.add(a * x, torch.matmul(bx_cx2, x), out=out)


def newton_schulz(m: torch.Tensor, steps: int = 5, eps: float = 1e-7, *,
                  iteration=_ns_step) -> torch.Tensor:
    """Orthogonalize the last two dims of ``m`` by ``steps`` NS iterations.

    Works in the wide orientation (rows <= cols), decided on the trailing two
    dims for the whole stack, so for Trion's (m, r) factor with m >= r every
    product is r-sized. Each matrix is divided by its Frobenius norm (a
    tensor: on CUDA a division by a Python scalar is a multiply by its
    reciprocal) into a contiguous wide buffer; ``iteration(x, out=y)`` then
    runs one step from one of two buffers into the other, ping-ponging
    between them. The default is the plain ``_ns_step``; the kernel path
    (``kernels/newton_schulz.py``) passes its own. A tall result is handed
    back as a transposed view. fp32 inside; returns the input dtype.
    """
    wide = m.shape[-2] <= m.shape[-1]
    x = (m if wide else m.mT).float()
    norm = torch.linalg.norm(x, dim=(-2, -1), keepdim=True)
    cur = torch.empty(x.shape, dtype=torch.float32, device=m.device)
    torch.div(x, norm + eps, out=cur)
    nxt = torch.empty_like(cur)
    for _ in range(steps):
        iteration(cur, out=nxt)
        cur, nxt = nxt, cur
    out = cur.to(m.dtype)
    return out if wide else out.mT
