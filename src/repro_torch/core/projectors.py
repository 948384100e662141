"""Pluggable low-rank projectors.

Every projector maps a gradient matrix ``G (..., m, n)`` (oriented so the
projected dimension is last, ``n <= m``) to a rank-r right basis and exposes
project / backproject. Two families, as in ``repro.core.projectors``:

* **Predefined-basis kinds**: every registered backend (``dct``, ``dst``,
  ``hadamard``, ``randortho``). The state is int32 indices ``(..., r)`` into
  the model-wide shared basis (paper: "only r integers per layer"), and
  selection ranks the backend's column energies.
* **Dense kinds**: per-matrix ``(..., n, r)`` fp32 bases: ``svd`` (top right
  singular vectors), ``power`` (one block power iteration, QR-orthonormalized),
  ``random`` (QR of a Gaussian, one per stacked layer); plus ``randperm``, a
  sorted random column subset of the identity (int32, one draw shared by the
  stacked layers). Their refreshes run ``torch.linalg`` on the gradient's
  device.

``random`` and ``randperm`` draw from a per-leaf integer key
(``optim.transform.leaf_key``) through :func:`gaussian_draw` and
:func:`permutation_draw`, each an explicit ``torch.Generator`` on the
tensor's device. That stream is the port's own: it cannot reproduce
``jax.random``, and a CPU and a CUDA generator give different draws for one
key.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .selection import allsum, back_project, gather_columns, select_top_r, take_columns
from .transforms import backend_kinds, get_backend, is_backend, shared_basis

#: projector kinds that are not predefined-basis backends
DENSE_KINDS = ("svd", "power", "random", "randperm")
_DENSE_BASIS = ("svd", "power", "random")


def projector_kinds() -> tuple[str, ...]:
    """Every valid ``Projector.kind``: the registered basis backends plus
    the dense kinds (a live view of the registry)."""
    return backend_kinds() + DENSE_KINDS


# import-time snapshot (validation goes through ``projector_kinds()``)
PROJECTOR_KINDS = projector_kinds()


def _unknown_kind(kind) -> ValueError:
    return ValueError(f"unknown projector kind {kind!r}; allowed: "
                      f"{projector_kinds()}")


def _generator(key: int, device) -> torch.Generator:
    if key is None:
        raise ValueError("random and randperm projectors need a per-leaf key")
    return torch.Generator(device=device).manual_seed(key)


def gaussian_draw(key: int, shape: tuple[int, ...], device) -> torch.Tensor:
    """Standard normal fp32 of ``shape`` from ``key`` (the ``random`` kind's
    draw, one ``(n, r)`` per stacked layer)."""
    return torch.randn(shape, generator=_generator(key, device),
                       dtype=torch.float32, device=device)


def permutation_draw(key: int, n: int, device) -> torch.Tensor:
    """A random permutation of ``range(n)`` from ``key`` (the ``randperm``
    kind's draw)."""
    return torch.randperm(n, generator=_generator(key, device), device=device)


@dataclasses.dataclass(frozen=True)
class Projector:
    """Rank-r right-projector. Backend kinds index into the shared basis
    ``shared_q``; dense kinds keep their basis in their state."""

    kind: str
    r: int
    norm: str = "l2"  # ranking norm of the backend kinds

    def __post_init__(self):
        if self.kind not in projector_kinds():
            raise _unknown_kind(self.kind)

    @property
    def backend(self):
        """The registered basis backend, or None for the dense kinds."""
        return get_backend(self.kind) if is_backend(self.kind) else None

    def _shared_q(self, shared_q: torch.Tensor | None, n: int,
                  device=None) -> torch.Tensor:
        """The caller's shared basis when given, else built by the backend."""
        if shared_q is not None:
            return shared_q
        return get_backend(self.kind).matrix(n, torch.float32, device)

    def init(self, shape: tuple[int, ...], device=None) -> torch.Tensor:
        """Initial state for a (stacked) matrix (..., m, n): indices
        ``arange(r)``, or ``eye(n, r)`` for the dense bases."""
        *batch, _, n = shape
        r = min(self.r, n)
        if self.index_based:
            idx = torch.arange(r, dtype=torch.int32, device=device)
            return idx.expand(*batch, r).contiguous()
        if self.kind in _DENSE_BASIS:
            eye = torch.eye(n, r, dtype=torch.float32, device=device)
            return eye.expand(*batch, n, r).contiguous()
        raise _unknown_kind(self.kind)

    def update(self, g: torch.Tensor, state: Any,
               shared_q: torch.Tensor | None = None, key: int | None = None,
               psum_axes=None) -> torch.Tensor:
        """Recompute the basis from the current gradient ``g``. ``key``: the
        per-leaf key of ``random`` / ``randperm``."""
        n = g.shape[-1]
        r = min(self.r, n)
        gf = g.float()
        backend = self.backend
        if backend is not None:
            stat = backend.energy_stat(gf, self._shared_q(shared_q, n, g.device),
                                       norm=self.norm, psum_axes=psum_axes)
            return select_top_r(stat, r)
        if self.kind == "svd":
            if psum_axes:
                raise ValueError("svd projector refresh needs the full "
                                 "gradient; it cannot run on ZeRO row "
                                 "shards (rule.zero_shardable gates this)")
            _, _, vh = torch.linalg.svd(gf, full_matrices=False)
            return vh[..., :r, :].transpose(-1, -2).contiguous()
        if self.kind == "power":
            # one block power iteration warm-started from the previous basis
            y = allsum(gf.transpose(-1, -2) @ (gf @ state), psum_axes)
            return torch.linalg.qr(y, mode="reduced").Q
        if self.kind == "random":
            gauss = gaussian_draw(key, (*g.shape[:-2], n, r), g.device)
            return torch.linalg.qr(gauss, mode="reduced").Q
        if self.kind == "randperm":
            perm = permutation_draw(key, n, g.device)[:r]
            idx = torch.sort(perm).values.to(torch.int32)
            return idx.expand(*g.shape[:-2], r).contiguous()
        raise _unknown_kind(self.kind)

    def project(self, g: torch.Tensor, state: Any,
                shared_q: torch.Tensor | None = None) -> torch.Tensor:
        """``g_low = G @ Q_r`` -> (..., m, r)."""
        if self.kind == "randperm":          # Q = I: a column take
            return take_columns(g, state)
        if is_backend(self.kind):
            q = self._shared_q(shared_q, g.shape[-1], g.device)
            return g @ gather_columns(q, state).to(g.dtype)
        if self.kind in _DENSE_BASIS:
            return g @ state.to(g.dtype)
        raise _unknown_kind(self.kind)

    def backproject(self, low: torch.Tensor, state: Any,
                    shared_q: torch.Tensor | None = None, n: int | None = None
                    ) -> torch.Tensor:
        """``G_hat = g_low @ Q_r^T`` -> (..., m, n)."""
        if self.index_based and shared_q is None and n is None:
            raise ValueError(f"{self.kind} backproject needs the full "
                             f"dimension `n` (or a shared_q to infer it from)")
        if self.kind == "randperm":          # scatter into zeros
            n = int(shared_q.shape[-1]) if n is None else n
            out = torch.zeros((*low.shape[:-1], n), dtype=low.dtype,
                              device=low.device)
            idx = state.long().unsqueeze(-2).expand(low.shape)
            return out.scatter(-1, idx, low)
        if is_backend(self.kind):
            q = self._shared_q(shared_q, n, low.device)
            return back_project(low, q.to(low.dtype), state)
        if self.kind in _DENSE_BASIS:
            return low @ state.to(low.dtype).transpose(-1, -2)
        raise _unknown_kind(self.kind)

    def basis_matrix(self, state: Any, n: int,
                     shared_q: torch.Tensor | None = None) -> torch.Tensor:
        """Materialize Q_r (..., n, r)."""
        if self.kind == "randperm":
            eye = torch.eye(n, dtype=torch.float32, device=state.device)
            return eye[state.long()].transpose(-1, -2)
        if is_backend(self.kind):
            return gather_columns(self._shared_q(shared_q, n, state.device),
                                  state)
        if self.kind in _DENSE_BASIS:
            return state
        raise _unknown_kind(self.kind)

    @property
    def index_based(self) -> bool:
        """State is an index set into one orthogonal matrix (every backend
        kind, and randperm's column subset of the identity)."""
        return is_backend(self.kind) or self.kind == "randperm"

    @property
    def needs_shared_basis(self) -> bool:
        return is_backend(self.kind)

    @property
    def needs_key(self) -> bool:
        if self.kind in ("random", "randperm"):
            return True
        backend = self.backend
        return backend is not None and backend.needs_key


def shared_basis_for(kind: str, n: int, dtype=torch.float32,
                     device=None) -> torch.Tensor | None:
    """The model-wide shared basis of a backend kind (from the process-wide
    BasisCache), None for the dense kinds."""
    if is_backend(kind):
        return shared_basis(kind, n, dtype, device)
    return None


def rotation_matrix(prev_state: torch.Tensor, crt_state: torch.Tensor,
                    projector: Projector, n: int,
                    shared_q: torch.Tensor | None = None,
                    exact_matmul: bool = False) -> torch.Tensor:
    """Subspace rotation ``R = Q_prev^T Q_crt`` (paper Alg. 3 line 8).

    For index-based projectors both index sets select columns of one
    orthogonal matrix, so ``R[a, b] = 1 iff prev_idx[a] == crt_idx[b]``: a
    0/1 partial permutation built by O(r^2) index compares instead of the
    O(n r^2) matmul. ``exact_matmul=True`` restores the paper-literal
    matmul, which the dense kinds always take.
    """
    if projector.index_based and not exact_matmul:
        return (prev_state[..., :, None] == crt_state[..., None, :]).float()
    qp = projector.basis_matrix(prev_state, n, shared_q).float()
    qc = projector.basis_matrix(crt_state, n, shared_q).float()
    return qp.transpose(-1, -2) @ qc
