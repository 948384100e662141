"""Dynamic column selection (paper §2.1, Appendix B).

Given ``S = G @ Q`` (scalar products of rows of ``G`` with columns of the
fixed orthogonal basis ``Q``), rank the columns of ``S`` by their l1/l2 norm
and keep the indices of the top ``r``. The top-r column alignments are the
optimal column subset of ``Q`` for Frobenius reconstruction (paper §4.1),
a contractive compressor: ``||G - Q_r Q_r^T G||_F^2 <= (1 - r/n) ||G||_F^2``.

Every function broadcasts over leading (stacked-layer) axes; the matrix
lives in the last two dims.

``allsum`` / ``allgather_rows`` / ``local_row_block`` are the ZeRO-1
collectives of ``repro.core.selection``; ZeRO is not yet ported, so they are
identities here and raise if asked for a shard axis.
"""
from __future__ import annotations

import torch


def _no_shards(axes) -> None:
    if axes:
        raise NotImplementedError("ZeRO-1 sharding is not yet ported to "
                                  "repro_torch")


def allsum(x: torch.Tensor, axes) -> torch.Tensor:
    """Cross-shard sum of a row-block-local reduction (identity unsharded)."""
    _no_shards(axes)
    return x


def allgather_rows(x: torch.Tensor, axes) -> torch.Tensor:
    """Row blocks of ``x`` gathered across shards (identity unsharded)."""
    _no_shards(axes)
    return x


def local_row_block(x: torch.Tensor, axes, block: int) -> torch.Tensor:
    """This shard's ``block`` rows of ``x`` (identity unsharded)."""
    _no_shards(axes)
    return x


def column_norms(s: torch.Tensor, ord: str = "l2") -> torch.Tensor:
    """Per-column ranking statistic of ``S`` over the row axis (-2), in fp32.
    ``l2`` is the *squared* l2 norm (the §4.1 quantity)."""
    sf = s.float()
    if ord == "l2":
        return (sf * sf).sum(dim=-2)
    if ord == "l1":
        return sf.abs().sum(dim=-2)
    raise ValueError(f"unknown norm {ord!r}")


def select_top_r(norms: torch.Tensor, r: int, sort: bool = True) -> torch.Tensor:
    """int32 indices of the ``r`` largest entries of ``norms`` (last axis).

    Ties go to the lower index, as ``lax.top_k`` breaks them in the JAX
    package: a *stable* descending sort keeps equal values in index order
    (``torch.topk`` promises no order among ties). ``sort=True`` returns the
    indices ascending, the canonical form the rotation bookkeeping uses.
    """
    n = norms.shape[-1]
    if n >= 2**31:
        raise ValueError(f"{n} columns do not fit int32 indices")
    idx = torch.sort(norms, dim=-1, descending=True, stable=True).indices[..., :r]
    if sort:
        idx = torch.sort(idx, dim=-1).values
    return idx.to(torch.int32)


def take_columns(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``S[..., :, idx]`` per leading index: (..., m, n), (..., r) -> (..., m, r)."""
    index = idx.long().unsqueeze(-2).expand(*s.shape[:-1], idx.shape[-1])
    return torch.gather(s, -1, index)


def dynamic_column_selection(s: torch.Tensor, r: int, ord: str = "l2",
                             sort: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank the columns of ``S`` and return ``(idx (..., r), b (..., m, r))``;
    ``b`` is cut out of ``S`` directly (paper Alg. 1 line 8)."""
    idx = select_top_r(column_norms(s, ord), r, sort=sort)
    return idx, take_columns(s, idx)


def gather_columns(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``Q_r = Q[:, idx]`` with broadcasting over leading axes of ``idx``:
    (n, n), (..., r) -> (..., n, r)."""
    return q.T[idx.long()].transpose(-1, -2)


def back_project(b: torch.Tensor, q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``b @ Q[:, idx].T``: (..., m, r) -> (..., m, n)."""
    return b @ q.T[idx.long()]


def dual_back_project(b1: torch.Tensor, b2: torch.Tensor, q: torch.Tensor,
                      idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two back-projections through the same selected columns, sharing one
    gather of ``Q^T``'s rows."""
    qr_t = q.T[idx.long()]                    # (..., r, n)
    return b1 @ qr_t, b2 @ qr_t


def index_overlap(prev_idx: torch.Tensor, new_idx: torch.Tensor) -> torch.Tensor:
    """Fraction of ``new_idx`` entries also present in ``prev_idx``."""
    eq = prev_idx[..., :, None] == new_idx[..., None, :]
    return eq.any(dim=-2).float().mean(dim=-1)


def topr_margin(norms: torch.Tensor, r: int) -> torch.Tensor:
    """``(v_r - v_{r+1}) / v_1``: how decisively the top-r cut separates the
    kept columns from the first dropped one. 1.0 when ``r >= n``."""
    n = norms.shape[-1]
    if r >= n:
        return torch.ones(norms.shape[:-1], dtype=torch.float32,
                          device=norms.device)
    v = torch.topk(norms.float(), r + 1, dim=-1).values
    return (v[..., r - 1] - v[..., r]) / (v[..., 0] + 1e-30)


def reconstruction_error_sq(g: torch.Tensor, q: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """``||G - G Q_r Q_r^T||_F^2`` by the §4.1 identity (right projection):
    ``||G||_F^2 - sum over the selected i of ||G q_i||_2^2``, no
    reconstruction materialized."""
    gf = g.float()
    norms = column_norms(gf @ q.float(), "l2")
    total = (gf * gf).sum(dim=(-2, -1))
    sel = torch.gather(norms, -1, idx.long()).sum(dim=-1)
    return total - sel
