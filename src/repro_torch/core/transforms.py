"""Pluggable orthogonal-basis backends and the shared BasisCache.

Any predefined orthogonal basis computed once at training start can replace
per-layer SVD/QR — DCT is one instance, chosen for its Makhoul FFT fast path
(DESIGN.md §2). A :class:`BasisBackend` supplies the ``(n, n)`` orthogonal
matrix, an optional fast transform and the column-energy statistic the
dynamic selection feeds on.

Only the ``dct`` backend is ported; ``dst``, ``hadamard`` and ``randortho``
of ``repro.core.transforms`` are still to come.

The process-wide :class:`BasisCache` (``shared_basis``) memoizes the
``(kind, n, dtype, device) -> matrix`` map, so one basis per distinct order
serves the whole model.
"""
from __future__ import annotations

import torch

from .dct import dct2_matrix, makhoul_dct2
from .selection import allsum, column_norms


class BasisBackend:
    """One predefined orthogonal basis family.

    Subclasses define ``kind`` and ``matrix``; the default ``apply_fast``
    and ``energy_stat`` are the matmul against ``matrix``.
    """

    kind: str = ""

    def matrix(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        """The ``(n, n)`` orthogonal basis ``Q`` (``x @ Q`` = transform)."""
        raise NotImplementedError

    def apply_fast(self, x: torch.Tensor, q: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """Row-wise transform ``x @ Q``: the fast path where one exists,
        else a matmul against ``q`` (or a freshly built matrix)."""
        if q is None:
            q = self.matrix(x.shape[-1], x.dtype, x.device)
        return x @ q.to(x.dtype)

    def energy_stat(self, g: torch.Tensor, q: torch.Tensor, *,
                    norm: str = "l2", psum_axes=None) -> torch.Tensor:
        """Per-column ranking statistic of ``S = G @ Q`` (..., n)."""
        s = g @ q.float()
        return allsum(column_norms(s, norm), psum_axes)


class DCTBackend(BasisBackend):
    """Orthonormal DCT-II — the paper's basis (core/dct.py conventions)."""

    kind = "dct"

    def matrix(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return dct2_matrix(n, dtype, device)

    def apply_fast(self, x: torch.Tensor, q: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """Makhoul's N-point FFT algorithm (paper Appendix D)."""
        return makhoul_dct2(x)


_REGISTRY: dict[str, BasisBackend] = {"dct": DCTBackend()}

#: basis kinds of the JAX registry this package does not build yet
NOT_YET_PORTED = ("dst", "hadamard", "randortho")


def get_backend(kind: str) -> BasisBackend:
    if kind in NOT_YET_PORTED:
        raise NotImplementedError(f"basis {kind!r} is not yet ported to "
                                  f"repro_torch; have {backend_kinds()}")
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown basis backend {kind!r}; registered: "
                         f"{backend_kinds()}") from None


def backend_kinds() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def is_backend(kind) -> bool:
    return kind in _REGISTRY


class BasisCache:
    """Process-wide ``(kind, n, dtype, device) -> (n, n) basis`` memo.

    Entries are handed out as they are stored: callers treat a basis as
    read-only. ``hits``/``misses`` make the reuse observable.
    """

    def __init__(self):
        self._store: dict[tuple[str, int, str, str], torch.Tensor] = {}
        self.hits = 0
        self.misses = 0

    def get(self, kind: str, n: int, dtype=torch.float32,
            device=None) -> torch.Tensor:
        device = torch.device(device or "cpu")
        key = (kind, int(n), str(dtype), str(device))
        hit = self._store.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        q = get_backend(kind).matrix(int(n), dtype, device)
        self.misses += 1
        self._store[key] = q
        return q


_CACHE = BasisCache()


def basis_cache() -> BasisCache:
    """The process-wide cache instance."""
    return _CACHE


def shared_basis(kind: str, n: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """The model-wide shared basis for ``kind``, via the process cache."""
    return _CACHE.get(kind, n, dtype, device)


def normalize_basis_request(item) -> tuple[str, int]:
    """``basis_sizes`` entries are ``(kind, n)`` pairs; bare ints are the
    legacy spelling for the DCT basis."""
    if isinstance(item, tuple):
        kind, n = item
        return kind, int(n)
    return "dct", int(item)


def basis_store_key(kind: str, n: int) -> str:
    """Key of a basis in the optimizer-state ``bases`` dict: bare ``str(n)``
    for DCT (as in the JAX state tree), ``"kind:n"`` otherwise."""
    return str(n) if kind == "dct" else f"{kind}:{n}"
