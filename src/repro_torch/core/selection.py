"""Dynamic column selection (paper §2.1, Appendix B).

Given ``S = G @ Q`` (scalar products of rows of ``G`` with columns of the
fixed orthogonal basis ``Q``), rank the columns of ``S`` by their l1/l2 norm
and keep the indices of the top ``r``. The top-r column alignments are the
optimal column subset of ``Q`` for Frobenius reconstruction (paper §4.1),
a contractive compressor: ``||G - Q_r Q_r^T G||_F^2 <= (1 - r/n) ||G||_F^2``.

Every function broadcasts over leading (stacked-layer) axes; the matrix
lives in the last two dims.

``allsum`` / ``allgather_rows`` / ``shard_index`` / ``local_row_block`` are
the ZeRO-1 collectives (``parallel/zero.py``) over the active mesh's process
groups (``parallel.sharding.set_mesh``), with the blocks in the order of the
reference's ``P(axes)`` layout: row-major over ``axes``. Each is an
identity when ``axes`` is empty, so the replicated step is untouched. Every
cross-shard sum is an all-gather followed by one fixed-order sum, so all
ranks get the same bits.
"""
from __future__ import annotations

import torch


def _mesh(axes):
    from repro_torch.parallel.sharding import active_mesh

    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"a collective over {tuple(axes)} needs an "
                           "active mesh (parallel.sharding.set_mesh)")
    return mesh


def _ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def allsum(x: torch.Tensor, axes) -> torch.Tensor:
    """Cross-shard sum of a row-block-local reduction: every shard's ``x``
    gathered and summed in shard order. Identity when ``axes`` is empty."""
    if not axes:
        return x
    return _ordered_sum(_mesh(axes).all_gather(x, axes))


def allsum_row_blocks(partial: torch.Tensor, axes) -> torch.Tensor:
    """Column totals from per-row-block partial sums ``(..., blocks, n)``:
    every shard's blocks gathered in shard order (the row order) and
    summed one block after another, from the first, as
    ``csrc/dct_project.cu``'s second stage sums the partials of a whole
    leaf. Without ``axes``, the same sum of this tensor's blocks."""
    p = allgather_rows(partial, axes)
    return _ordered_sum([p[..., t, :] for t in range(p.shape[-2])])


def allgather_rows(x: torch.Tensor, axes) -> torch.Tensor:
    """The row blocks (dim -2) of ``x`` across the shards, concatenated in
    the whole array's row order: the inverse of :func:`local_row_block`.
    Identity when ``axes`` is empty."""
    if not axes:
        return x
    return torch.cat(_mesh(axes).all_gather(x, axes), dim=-2)


def shard_index(axes) -> int:
    """This rank's position along ``axes`` (row-major, the ``P(axes)``
    block order); 0 when ``axes`` is empty."""
    if not axes:
        return 0
    return _mesh(axes).shard_index(axes)


def local_row_block(x: torch.Tensor, axes, block: int) -> torch.Tensor:
    """This shard's ``block`` rows (dim -2) of a whole-row array, a view:
    the inverse of :func:`allgather_rows`. Identity when ``axes`` is
    empty."""
    if not axes:
        return x
    return x.narrow(x.dim() - 2, shard_index(axes) * block, block)


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
