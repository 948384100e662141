"""Pluggable orthogonal-basis backends and the shared BasisCache.

Any predefined orthogonal basis computed once at training start can replace
per-layer SVD/QR — DCT is one instance, chosen for its Makhoul FFT fast path
(DESIGN.md §2). A :class:`BasisBackend` supplies the ``(n, n)`` orthogonal
matrix, an optional fast transform and the column-energy statistic the
dynamic selection feeds on.

Built-in backends (``register_backend`` adds more):

  ``dct``       DCT-II — Makhoul N-point FFT fast path (``torch.fft``).
  ``dst``       DST-II — the sine sibling (same exact-int32 phase
                reduction); matmul only.
  ``hadamard``  Walsh–Hadamard (Sylvester order) — entries ±1/sqrt(n); an
                FWHT butterfly fast path for power-of-two n, the
                block-diagonal Sylvester form applied by matmul otherwise.
  ``randortho`` Seeded random orthogonal (QR of a fixed-seed Gaussian,
                sign-canonicalized). Drawn from a ``torch.Generator``: the
                same seed gives another matrix than the JAX package's
                ``jax.random`` stream (parity tests hand the JAX matrix to
                the port through the ``BasisCache``).

On the kernel path every backend goes through ``dct_project`` and
``colgather_matmul`` with its own ``Q``.

The process-wide :class:`BasisCache` (``shared_basis``) memoizes the
``(kind, n, dtype, device) -> matrix`` map, so one basis per distinct order
serves the whole model.
"""
from __future__ import annotations

import numpy as np
import torch

from .dct import _MAX_DCT_ORDER, dct2_matrix, makhoul_dct2
from .selection import allsum, column_norms


class BasisBackend:
    """One predefined orthogonal basis family.

    Subclasses define ``kind`` and ``matrix``; the default ``apply_fast``
    and ``energy_stat`` are the matmul against ``matrix``.
    """

    kind: str = ""
    #: a per-leaf key is needed at refresh (none of the built-ins:
    #: ``randortho`` is a fixed seeded basis, cached process-wide)
    needs_key: bool = False
    #: the energy statistic decomposes over row blocks (ZeRO-1 eligible)
    zero_shardable: bool = True

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


def dst2_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal DST-II matrix: ``x @ dst2_matrix(n)`` is the row-wise
    DST-II with the last basis vector scaled by 1/sqrt(2) (``Q^T Q = I``).

    The integer phase ``(2j+1)(k+1) mod 4n`` is reduced exactly in int32
    before the fp32 ``sin``, as for the DCT (core/dct.py)."""
    if n > _MAX_DCT_ORDER:
        raise ValueError(f"DST order {n} exceeds int32-exact phase range")
    j = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    k = torch.arange(n, dtype=torch.int32, device=device)[None, :]
    phase = ((2 * j + 1) * (k + 1)) % (4 * n)      # exact in int32
    ang = phase.to(torch.float32) * np.float32(np.pi / (2.0 * n))
    q = np.float32(np.sqrt(2.0 / n)) * torch.sin(ang)
    q[:, n - 1] *= np.float32(1.0 / np.sqrt(2.0))
    return q.to(dtype)


class DSTBackend(BasisBackend):
    """Orthonormal DST-II; no fast path (matmul against the matrix)."""

    kind = "dst"

    def matrix(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return dst2_matrix(n, dtype, device)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh–Hadamard transform along the last axis (Sylvester order,
    *unnormalized*): ``fwht(x) == x @ H_n`` for the ±1 Sylvester matrix.
    Power-of-two length only; log2(n) add/subtract passes."""
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"fwht needs a power-of-two length, got {n}")
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    return x


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal Walsh–Hadamard basis of order ``n``.

    Power-of-two ``n``: the Sylvester matrix ``H[i, j] = (-1)^popcount(i & j)
    / sqrt(n)``. Other ``n``: the orthogonal block-diagonal of Sylvester
    blocks following the binary decomposition of ``n`` (40 = 32 + 8),
    largest first."""
    if _is_pow2(n):
        i = torch.arange(n, device=device)[:, None]
        j = torch.arange(n, device=device)[None, :]
        ij = i & j
        par = torch.zeros_like(ij)
        for bit in range(n.bit_length()):
            par ^= (ij >> bit) & 1
        sign = 1.0 - 2.0 * par.to(torch.float32)
        return (sign * np.float32(1.0 / np.sqrt(n))).to(dtype)
    q = torch.zeros((n, n), dtype=torch.float32, device=device)
    off = 0
    for bit in reversed(range(n.bit_length())):        # big blocks first
        blk = 1 << bit
        if n & blk:
            q[off:off + blk, off:off + blk] = hadamard_matrix(blk,
                                                             device=device)
            off += blk
    return q.to(dtype)


class HadamardBackend(BasisBackend):
    """Walsh–Hadamard basis: ±1/sqrt(n) entries and an FWHT butterfly for
    power-of-two n (the matmul otherwise)."""

    kind = "hadamard"

    def matrix(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return hadamard_matrix(n, dtype, device)

    def apply_fast(self, x: torch.Tensor, q: torch.Tensor | None = None
                   ) -> torch.Tensor:
        n = x.shape[-1]
        if not _is_pow2(n):                            # matmul for other n
            return super().apply_fast(x, q)
        y = fwht(x.float()) * np.float32(1.0 / np.sqrt(n))
        return y.to(x.dtype)


def random_orthogonal_matrix(n: int, dtype=torch.float32, seed: int = 0,
                             device=None) -> torch.Tensor:
    """Deterministic random orthogonal basis: QR of a fixed-seed Gaussian
    drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
    sign-canonicalized (diag(R) >= 0). Another stream than the JAX
    package's ``jax.random``: the same seed gives another (equally valid)
    basis."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((n, n), generator=gen, dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    q = q * torch.where(torch.diagonal(r) < 0, -1.0, 1.0)[None, :]
    return q.to(device=device, dtype=dtype)


class RandOrthoBackend(BasisBackend):
    """Seeded random-orthogonal basis: one shared ``(n, n)`` orthogonal
    matrix with index-set selection, the predefined-basis ablation against
    DCT/DST/Hadamard."""

    kind = "randortho"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def matrix(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return random_orthogonal_matrix(n, dtype, self.seed, device)


_REGISTRY: dict[str, BasisBackend] = {}


def register_backend(backend: BasisBackend, *, overwrite: bool = False) -> None:
    """Add a backend to the registry (``Projector`` and the presets dispatch
    on ``backend.kind``). Refuses silent replacement unless ``overwrite``."""
    if not backend.kind:
        raise ValueError("backend needs a non-empty .kind")
    if backend.kind in _REGISTRY and not overwrite:
        raise ValueError(f"basis backend {backend.kind!r} already "
                         f"registered; pass overwrite=True to replace")
    _REGISTRY[backend.kind] = backend


def get_backend(kind: str) -> BasisBackend:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown basis backend {kind!r}; registered: "
                         f"{backend_kinds()}") from None


def backend_kinds() -> tuple[str, ...]:
    """Registered predefined-basis kinds (registration order)."""
    return tuple(_REGISTRY)


def is_backend(kind) -> bool:
    return kind in _REGISTRY


for _backend in (DCTBackend(), DSTBackend(), HadamardBackend(),
                 RandOrthoBackend()):
    register_backend(_backend)


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

    def put(self, kind: str, n: int, q: torch.Tensor) -> None:
        """Store ``q`` as the ``(kind, n)`` basis of its dtype and device: a
        basis made elsewhere (the JAX package's randortho, whose stream this
        package cannot draw) then serves every later ``get``."""
        if tuple(q.shape) != (n, n):
            raise ValueError(f"basis of shape {tuple(q.shape)} for n={n}")
        self._store[(kind, int(n), str(q.dtype), str(q.device))] = q

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store)}

    def clear(self) -> None:
        self._store.clear()
        self.hits = 0
        self.misses = 0


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
