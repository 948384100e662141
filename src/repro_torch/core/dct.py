"""Discrete Cosine Transform bases and the fast Makhoul FFT transform.

Conventions (paper §2.2 / Appendix A), as in ``repro/core/dct.py``:
  * ``dct3_matrix(n)`` is the paper's ``Q``: ``Q[i, j] = sqrt(2/n) *
    cos(i * (2j + 1) * pi / (2n))`` with the first **row** divided by
    ``sqrt(2)``. ``Q @ Q.T = Q.T @ Q = I``.
  * ``dct2_matrix(n) = dct3_matrix(n).T``; ``x @ dct2_matrix(n)`` is the
    row-wise orthonormal DCT-II of ``x``, which Makhoul's N-point FFT
    algorithm computes in ``O(n log n)`` per row (paper Appendix D).

Precision: the integer phase ``i*(2j+1) mod 4n`` is reduced exactly in int32
before the fp32 cosine (cos has period ``2*pi`` = phase ``4n``), so every
argument is below ``2*pi`` and the entries are ~1e-7 accurate at any
supported order.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# (n-1)*(2n-1) must fit int32 for the exact phase reduction.
_MAX_DCT_ORDER = 32_000


def dct3_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Paper Appendix A DCT-III matrix of order ``n`` (orthonormal)."""
    if n > _MAX_DCT_ORDER:
        raise ValueError(f"DCT order {n} exceeds int32-exact phase range")
    i = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    phase = (i * (2 * j + 1)) % (4 * n)           # exact in int32
    ang = phase.to(torch.float32) * np.float32(np.pi / (2.0 * n))
    q = np.float32(np.sqrt(2.0 / n)) * torch.cos(ang)
    q[0, :] *= np.float32(1.0 / np.sqrt(2.0))
    return q.to(dtype)


def dct2_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """DCT-II matrix = transpose of DCT-III (a contiguous copy, not a view).
    ``x @ dct2_matrix(n)`` = DCT-II."""
    return dct3_matrix(n, dtype, device).T.contiguous()


def dct_basis_np(n: int) -> np.ndarray:
    """Float64 NumPy DCT-III basis: the test oracle."""
    i = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    q = np.sqrt(2.0 / n) * np.cos(i * (2.0 * j + 1.0) * (np.pi / (2.0 * n)))
    q[0, :] /= np.sqrt(2.0)
    return q


@functools.lru_cache(maxsize=64)
def _makhoul_permutation(n: int) -> np.ndarray:
    """Makhoul input permutation: [a b c d e f] -> [a c e f d b]: even
    indices ascending, then odd indices descending (Appendix D step 1)."""
    idx = np.arange(n)
    return np.ascontiguousarray(np.concatenate([idx[0::2], idx[1::2][::-1]]))


def makhoul_dct2(x: torch.Tensor) -> torch.Tensor:
    """Row-wise orthonormal DCT-II via Makhoul's N-point FFT algorithm
    (``torch.fft``): permute -> FFT -> twiddle by ``W_k = exp(-i*pi*k/(2n))``
    -> real part -> orthonormal scaling. Equal to fp32 tolerance to
    ``x @ dct2_matrix(n)``."""
    n = x.shape[-1]
    perm = torch.as_tensor(_makhoul_permutation(n), device=x.device)
    v = torch.index_select(x.float(), -1, perm)
    vf = torch.fft.fft(v, dim=-1)
    k = torch.arange(n, dtype=torch.float32, device=x.device)
    w = torch.exp(-1j * (math.pi / (2.0 * n)) * k.to(torch.complex64))
    y = 2.0 * torch.real(vf * w)                   # factor-2 DCT-II
    # orthonormal scaling: y0 *= sqrt(1/(4n)); yk *= sqrt(1/(2n))
    scale = torch.full((n,), np.sqrt(1.0 / (2.0 * n)), dtype=torch.float32,
                       device=x.device)
    scale[0] = np.sqrt(1.0 / (4.0 * n))
    return (y * scale).to(x.dtype)



def dct2(x: torch.Tensor, method: str = "matmul") -> torch.Tensor:
    """Row-wise orthonormal DCT-II: the similarity transform ``S = G @ Q``.
    ``method="matmul"`` multiplies by ``dct2_matrix``; ``"fft"`` is
    Makhoul's algorithm on ``torch.fft``."""
    if method == "fft":
        return makhoul_dct2(x)
    if method != "matmul":
        raise ValueError(f"unknown method {method!r}; expected 'matmul' or "
                         f"'fft'")
    return x @ dct2_matrix(x.shape[-1], x.dtype, x.device)
