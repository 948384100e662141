"""Paged flash decode: single-query GQA attention through a block table.

Continuous-batching decode keeps every sequence's K/V in fixed-size blocks
of one global pool (``serve/kv_cache.py``); slot ``b``'s token ``t`` lies
at ``pool[block_table[b, t // bs], t % bs]``. Each slot's one new query
attends to its first ``lengths[b]`` tokens (the last ``window`` of them
with a sliding window). The block-table walk is cut into ``num_splits``
column ranges whose unnormalized online-softmax partials ``(acc, m, l)``
are merged with the max-shift algebra (``merge_splits``). A slot of length
0 gets an exact zero row.

On CUDA tensors ``flash_decode`` launches the kernels of
``csrc/flash_decode.cu`` (replacing ``repro/kernels/flash_decode.py::
_kernel`` and its jnp merge; bound by the bytes of the K/V it reads — see
the source note), or raises. The work reaches the card cut by the table,
not by the caller's splits: ``plan_ranges`` cuts each split further into
ranges of about ``RANGE_TOKENS`` tokens, each range's partial goes to fp32
scratch, and a second kernel merges the live ranges in order with the same
algebra (the same function up to the order of fp32 sums). bf16 pools whose
head dim is a multiple of 8 are read as 16-byte vectors (``vector_path``);
fp32 pools and other head dims take a scalar path. On CPU tensors it runs
``flash_decode_plain``: the pool densified through the table, masked fp32
softmax per split, then the same merge.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib

NEG_INF = -1e30
#: tokens of table columns one range of the kernel covers (the caller's
#: splits are cut into ranges of ``max(1, RANGE_TOKENS // bs)`` columns)
RANGE_TOKENS = 128


def merge_splits(o_part: torch.Tensor, m_part: torch.Tensor,
                 l_part: torch.Tensor) -> torch.Tensor:
    """Merge split partials along axis 0: ``o_part`` (S, ..., hd), ``m_part``
    and ``l_part`` (S, ..., 1), all fp32. Splits that saw no token (m =
    -1e30, l = 0) get weight 0; a row with no token at all gives 0."""
    m_star = m_part.amax(dim=0, keepdim=True)
    alpha = torch.exp(m_part - torch.clamp_min(m_star, NEG_INF / 2))
    l_tot = (alpha * l_part).sum(dim=0)
    acc = (alpha * o_part).sum(dim=0)
    return acc / torch.clamp_min(l_tot, 1e-30)


def _check_shapes(q, k_pool, v_pool, block_table, lengths):
    b, hq, hd = q.shape
    nb, bs, hkv, hd_k = k_pool.shape
    if hd_k != hd or tuple(v_pool.shape) != tuple(k_pool.shape) \
            or hq % hkv or block_table.dim() != 2 \
            or block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"flash_decode: shapes q {tuple(q.shape)} pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} table "
            f"{tuple(block_table.shape)} lengths {tuple(lengths.shape)} "
            f"do not fit")
    return b, hq, hd, nb, bs, hkv, block_table.shape[1]


def flash_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *, window: int | None = None,
                       num_splits: int = 1) -> torch.Tensor:
    """Plain version: gather each slot's blocks into a dense (B, S, Hkv, hd)
    cache, fp32 masked softmax attention in each split's column range,
    ``merge_splits``. With one split this is the JAX package's
    ``flash_decode_ref``. Masked positions get weight 0 and their V rows are
    zeroed, so NaNs in blocks a slot does not reach never leak in."""
    b, hq, hd, nb, bs, hkv, maxb = _check_shapes(q, k_pool, v_pool,
                                                 block_table, lengths)
    group = hq // hkv
    splits = max(1, min(num_splits, maxb))
    bps = -(-maxb // splits)
    tab = block_table.long()
    k = k_pool[tab].reshape(b, maxb * bs, hkv, hd).float()
    v = v_pool[tab].reshape(b, maxb * bs, hkv, hd).float()
    pos = torch.arange(maxb * bs, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = pos < ln
    if window is not None:
        mask &= pos >= ln - window
    v = torch.where(mask[:, :, None, None], v, 0.0)
    qg = q.reshape(b, hkv, group, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(hd)
    mask4 = mask[:, None, None, :]
    scores = torch.where(mask4, scores, NEG_INF)
    parts = []
    for s in range(splits):
        # the last splits may hold no column (MAXB < splits * bps): their
        # partial is the empty state (0, -1e30, 0), as in the kernel
        sl = slice(min(s * bps, maxb) * bs, min((s + 1) * bps, maxb) * bs)
        sc, mk = scores[..., sl], mask4[..., sl]
        m = torch.cat([sc, torch.full_like(scores[..., :1], NEG_INF)],
                      dim=-1).amax(dim=-1, keepdim=True)
        p = torch.where(mk, torch.exp(sc - m), 0.0)
        acc = torch.einsum("bhgs,bshd->bhgd", p, v[:, sl])
        parts.append((acc, m, p.sum(dim=-1, keepdim=True)))
    o_part, m_part, l_part = (torch.stack(t) for t in zip(*parts))
    out = merge_splits(o_part, m_part, l_part)
    return out.reshape(b, hq, hd).to(q.dtype)


def plan_ranges(maxb: int, bs: int, num_splits: int
                ) -> tuple[int, int, int, int]:
    """How the kernel cuts the table: ``(splits, bps, cols, per_split)``.
    ``splits`` is ``num_splits`` clamped to [1, MAXB]; split ``s`` holds
    columns ``[s * bps, min((s + 1) * bps, MAXB))`` (``bps`` = MAXB /
    splits rounded up, as the plain version cuts them); each split is cut
    into ``per_split`` ranges of ``cols`` columns (the last may be
    shorter or empty), range ``p = s * per_split + j``."""
    splits = max(1, min(num_splits, maxb))
    bps = -(-maxb // splits)
    cols = max(1, min(bps, RANGE_TOKENS // bs))
    return splits, bps, cols, -(-bps // cols)


def vector_path(k_pool: torch.Tensor, v_pool: torch.Tensor) -> bool:
    """Whether the kernel reads the pools as 16-byte vectors: bf16, a head
    dim that is a multiple of 8 and both pools on 16 bytes (else one
    element a lane)."""
    return (k_pool.dtype == torch.bfloat16 and k_pool.shape[-1] % 8 == 0
            and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0)


def flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 window: int | None = None, num_splits: int = 1
                 ) -> torch.Tensor:
    """q: (B, Hq, hd); k_pool / v_pool: (NB, bs, Hkv, hd) of one layer;
    block_table: (B, MAXB) int32 pool-block ids (entries past a slot's
    length are never read); lengths: (B,) int32 valid tokens per slot.
    ``Hq % Hkv == 0``. ``num_splits`` is clamped to [1, MAXB]. Returns
    (B, Hq, hd) in q's dtype."""
    b, hq, hd, nb, bs, hkv, maxb = _check_shapes(q, k_pool, v_pool,
                                                 block_table, lengths)
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} < 1")
    splits = max(1, min(num_splits, maxb))
    dev = cuda_lib.same_device(q, k_pool, v_pool, block_table, lengths)
    if dev.type == "cpu":
        return flash_decode_plain(q, k_pool, v_pool, block_table, lengths,
                                  window=window, num_splits=splits)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_pool.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: q {q.dtype} and pools {k_pool.dtype} "
                        f"must be float32 or bfloat16")
    cuda_lib.require_cuda("flash_decode q", q, q.dtype)
    cuda_lib.require_cuda("flash_decode k_pool", k_pool, k_pool.dtype)
    cuda_lib.require_cuda("flash_decode v_pool", v_pool, k_pool.dtype)
    cuda_lib.require_cuda("flash_decode block_table", block_table, torch.int32)
    cuda_lib.require_cuda("flash_decode lengths", lengths, torch.int32)
    if hd > 256 or b * hq >= 2**31 or maxb * bs >= 2**31:
        raise ValueError(f"flash_decode: head dim {hd} > 256 or shape "
                         f"q {tuple(q.shape)} table {tuple(block_table.shape)}"
                         f" exceeds the grid")
    splits, bps, cols, per_split = plan_ranges(maxb, bs, splits)
    parts = splits * per_split
    if parts >= 2**16:
        raise ValueError(f"flash_decode: {parts} table ranges exceed the "
                         f"grid")
    o_part = torch.empty((parts, b * hq, hd), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((parts, b * hq), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    rc = cuda_lib.library().repro_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(), b, hq, hkv, hd,
        nb, bs, maxb, splits, bps, cols, per_split, window or 0,
        1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        int(k_pool.dtype == torch.bfloat16),
        int(vector_path(k_pool, v_pool)), cuda_lib.stream(q))
    cuda_lib.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
