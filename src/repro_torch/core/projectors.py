"""Pluggable low-rank projectors.

Every projector maps a gradient matrix ``G (..., m, n)`` (oriented so the
projected dimension is last, ``n <= m``) to a rank-r right basis and exposes
project / backproject. For a predefined-basis kind the state is int32
indices ``(..., r)`` into the model-wide shared basis (paper: "only r
integers per layer"), and selection ranks the backend's column energies.

The predefined-basis kinds (every registered backend: ``dct``, ``dst``,
``hadamard``, ``randortho``) are ported. The dense kinds of
``repro.core.projectors`` (``svd``, ``power``, ``random``, ``randperm``) are
still to come.
"""
from __future__ import annotations

import dataclasses

import torch

from .selection import back_project, gather_columns, select_top_r
from .transforms import backend_kinds, get_backend

#: projector kinds of the JAX package this package does not build yet
NOT_YET_PORTED = ("svd", "power", "random", "randperm")


def projector_kinds() -> tuple[str, ...]:
    return backend_kinds()


@dataclasses.dataclass(frozen=True)
class Projector:
    """Rank-r right-projector into a shared predefined basis."""

    kind: str
    r: int
    norm: str = "l2"  # ranking norm

    def __post_init__(self):
        if self.kind in NOT_YET_PORTED:
            raise NotImplementedError(f"projector {self.kind!r} is not yet "
                                      f"ported to repro_torch")
        if self.kind not in projector_kinds():
            raise ValueError(f"unknown projector kind {self.kind!r}; "
                             f"allowed: {projector_kinds()}")

    @property
    def backend(self):
        return get_backend(self.kind)

    def _shared_q(self, shared_q: torch.Tensor | None, n: int,
                  device=None) -> torch.Tensor:
        """The caller's shared basis when given, else built by the backend."""
        if shared_q is not None:
            return shared_q
        return self.backend.matrix(n, torch.float32, device)

    def init(self, shape: tuple[int, ...], device=None) -> torch.Tensor:
        """Initial indices ``arange(r)`` for a (stacked) matrix (..., m, n)."""
        *batch, _, n = shape
        r = min(self.r, n)
        idx = torch.arange(r, dtype=torch.int32, device=device)
        return idx.expand(*batch, r).contiguous()

    def update(self, g: torch.Tensor, state: torch.Tensor,
               shared_q: torch.Tensor | None = None, psum_axes=None
               ) -> torch.Tensor:
        """New indices from the column energies of ``G @ Q``."""
        n = g.shape[-1]
        gf = g.float()
        stat = self.backend.energy_stat(gf, self._shared_q(shared_q, n, g.device),
                                        norm=self.norm, psum_axes=psum_axes)
        return select_top_r(stat, min(self.r, n))

    def project(self, g: torch.Tensor, state: torch.Tensor,
                shared_q: torch.Tensor | None = None) -> torch.Tensor:
        """``g_low = G @ Q_r`` -> (..., m, r)."""
        q = self._shared_q(shared_q, g.shape[-1], g.device)
        return g @ gather_columns(q, state).to(g.dtype)

    def backproject(self, low: torch.Tensor, state: torch.Tensor,
                    shared_q: torch.Tensor | None = None, n: int | None = None
                    ) -> torch.Tensor:
        """``G_hat = g_low @ Q_r^T`` -> (..., m, n)."""
        if shared_q is None and n is None:
            raise ValueError(f"{self.kind} backproject needs the full "
                             f"dimension `n` (or a shared_q to infer it from)")
        q = self._shared_q(shared_q, n, low.device)
        return back_project(low, q.to(low.dtype), state)

    def basis_matrix(self, state: torch.Tensor, n: int,
                     shared_q: torch.Tensor | None = None) -> torch.Tensor:
        """Materialize Q_r (..., n, r)."""
        return gather_columns(self._shared_q(shared_q, n, state.device), state)

    @property
    def index_based(self) -> bool:
        return True


def rotation_matrix(prev_state: torch.Tensor, crt_state: torch.Tensor,
                    projector: Projector, n: int,
                    shared_q: torch.Tensor | None = None,
                    exact_matmul: bool = False) -> torch.Tensor:
    """Subspace rotation ``R = Q_prev^T Q_crt`` (paper Alg. 3 line 8).

    Both index sets select columns of one orthogonal matrix, so
    ``R[a, b] = 1 iff prev_idx[a] == crt_idx[b]``: a 0/1 partial
    permutation built by O(r^2) index compares instead of the O(n r^2)
    matmul. ``exact_matmul=True`` restores the paper-literal matmul.
    """
    if projector.index_based and not exact_matmul:
        return (prev_state[..., :, None] == crt_state[..., None, :]).float()
    qp = projector.basis_matrix(prev_state, n, shared_q).float()
    qc = projector.basis_matrix(crt_state, n, shared_q).float()
    return qp.transpose(-1, -2) @ qc
