"""Paged KV cache: a global pool of fixed-size token blocks.

A dense ``(B, max_len, Hkv, hd)`` cache per layer charges every admitted
sequence for ``max_len`` tokens whether it uses them or not. Here cache
memory is a single pool of ``num_blocks`` blocks of ``block_size`` tokens
each (per attention layer), and every sequence owns a *block table*: the
ordered list of pool blocks holding its tokens. Token ``t`` of a sequence
lives at ``pool[table[t // block_size], t % block_size]``.

Two halves, as in ``repro/serve/kv_cache.py``:

  * :class:`BlockAllocator` — the host-side free-list.
    ``alloc`` / ``extend`` / ``free`` move block ids between the free list
    and per-sequence tables; admission backpressure is a ``can_alloc``
    check, never an exception mid-stream. Stats report utilization
    (tokens held / token capacity of the blocks held) and internal
    fragmentation (the complement: tail-of-block waste).
  * :class:`PagedKVCache` — the device pools, a flat dict
    ``segments/{i}/p{j}/k`` / ``/v`` of ``(repeats, num_blocks,
    block_size, Hkv, hd)`` tensors, plus the padded int32 block table the
    flash-decode kernel reads. The table is kept on the host and uploaded
    only after it changed.

Block ids are shared across layers: one table entry addresses the same
block index in every layer's pool, so the allocator is layer-agnostic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.devices import resolve_device

# the block kinds the paged path serves, from the model layer
from repro_torch.models.transformer import PAGED_KINDS, paged_supported  # noqa: F401


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``n_tokens``."""
    return -(-max(n_tokens, 0) // block_size)


class OutOfBlocksError(RuntimeError):
    """Raised by ``alloc``/``extend`` when the pool cannot satisfy a
    reservation the caller did not pre-check with ``can_alloc``."""


class BlockAllocator:
    """Host-side free-list over ``num_blocks`` pool blocks.

    Sequences are keyed by an opaque hashable id. ``alloc`` reserves
    blocks for a token budget, ``extend`` grows an existing
    reservation, ``free`` returns every block. Freed blocks go to the
    tail of the free list (FIFO) so reuse is deterministic and easy to
    assert in tests.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks))
        self._tables: dict[object, list[int]] = {}
        self._lengths: dict[object, int] = {}

    # -- queries ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def can_alloc(self, n_tokens: int) -> bool:
        return blocks_for(n_tokens, self.block_size) <= len(self._free)

    def table(self, seq_id) -> list[int]:
        """The live block-id list for ``seq_id`` (do not mutate)."""
        return self._tables[seq_id]

    def length(self, seq_id) -> int:
        return self._lengths[seq_id]

    # -- mutations --------------------------------------------------------
    def alloc(self, seq_id, n_tokens: int) -> list[int]:
        """Reserve blocks for ``n_tokens`` tokens. Returns the table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        need = blocks_for(n_tokens, self.block_size)
        if need > len(self._free):
            raise OutOfBlocksError(
                f"need {need} blocks, {len(self._free)} free")
        self._tables[seq_id] = [self._free.pop(0) for _ in range(need)]
        self._lengths[seq_id] = n_tokens
        return self._tables[seq_id]

    def extend(self, seq_id, new_len: int) -> list[int]:
        """Grow ``seq_id``'s reservation to ``new_len`` tokens. Returns
        the newly appended block ids (possibly empty)."""
        table = self._tables[seq_id]
        need = blocks_for(new_len, self.block_size) - len(table)
        if need > len(self._free):
            raise OutOfBlocksError(
                f"extend needs {need} blocks, {len(self._free)} free")
        fresh = [self._free.pop(0) for _ in range(max(need, 0))]
        table.extend(fresh)
        self._lengths[seq_id] = max(self._lengths[seq_id], new_len)
        return fresh

    def free(self, seq_id) -> int:
        """Return every block of ``seq_id`` to the pool; returns count."""
        table = self._tables.pop(seq_id)
        self._lengths.pop(seq_id)
        self._free.extend(table)
        return len(table)

    # -- stats ------------------------------------------------------------
    def stats(self) -> dict:
        """Pool occupancy: used/free blocks, token utilization of the
        held blocks, and internal fragmentation (1 - utilization)."""
        held_tokens = sum(self._lengths.values())
        held_capacity = self.used_blocks * self.block_size
        util = held_tokens / held_capacity if held_capacity else 0.0
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "sequences": len(self._tables),
            "held_tokens": held_tokens,
            "utilization": util,
            "fragmentation": 1.0 - util if held_capacity else 0.0,
        }


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Sizing for one :class:`PagedKVCache`.

    ``num_blocks`` is the pool's global budget; ``max_blocks_per_seq``
    bounds one sequence's table (= max model length / block_size) and
    fixes the padded block-table width the jit'd step sees, so batch
    composition can churn without retracing.
    """
    block_size: int
    num_blocks: int
    max_blocks_per_seq: int

    @property
    def max_seq_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq


class PagedKVCache:
    """Device pools + host allocator + the padded block-table array.

    ``pools`` mirrors the model's segment/scan structure:
    ``pools[seg][f"p{j}"] = {"k": (R, NB, bs, Hkv, hd), "v": ...}`` for
    every attention position — the exact pytree
    ``models.transformer.decode_step_paged`` scans over.

    The block table is kept as a host ``(num_slots, max_blocks_per_seq)``
    int32 array (mutated at admit/retire/extend boundaries only) and
    uploaded to the pools' device when a step finds it changed; unused
    entries hold 0 and are never read because the kernel skips blocks past
    each slot's length. The pools live on ``device`` (None: the card;
    ``resolve_device``).
    """

    def __init__(self, cfg, cache_cfg: PagedCacheConfig, num_slots: int,
                 device=None):
        from repro_torch.models import transformer as T

        self.model_cfg = cfg
        self.cfg = cache_cfg
        self.num_slots = num_slots
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(cache_cfg.num_blocks,
                                        cache_cfg.block_size)
        self.pools = T.init_paged_pools(cfg, cache_cfg.num_blocks,
                                        cache_cfg.block_size, self.device)
        self._table = np.zeros((num_slots, cache_cfg.max_blocks_per_seq),
                               np.int32)
        self._table_dev: torch.Tensor | None = None

    # -- table maintenance (host) -----------------------------------------
    def bind_slot(self, slot: int, seq_id) -> None:
        """Copy ``seq_id``'s (padded) block list into table row ``slot``."""
        blocks = self.allocator.table(seq_id)
        if len(blocks) > self.cfg.max_blocks_per_seq:
            raise ValueError("sequence exceeds max_blocks_per_seq")
        row = np.zeros((self.cfg.max_blocks_per_seq,), np.int32)
        row[:len(blocks)] = blocks
        self._table[slot] = row
        self._table_dev = None

    def clear_slot(self, slot: int) -> None:
        self._table[slot] = 0
        self._table_dev = None

    def block_table(self) -> torch.Tensor:
        """The padded int32 block table on the pools' device."""
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table.copy()).to(
                self.device)
        return self._table_dev

    # -- sizing -----------------------------------------------------------
    def cache_bytes(self) -> int:
        """Total bytes held by the paged pools."""
        return sum(x.numel() * x.element_size() for x in self.pools.values())

    def dense_bytes_equivalent(self) -> int:
        """Bytes a dense ``(num_slots, max_seq_len)`` cache of the same
        capacity would hold (the apples-to-apples comparison the
        serve benchmark gates on)."""
        per_token = 0
        for x in self.pools.values():
            r = x.shape[0]
            rest = int(np.prod(x.shape[3:]))
            per_token += r * rest * x.element_size()
        return per_token * self.num_slots * self.cfg.max_seq_len

    def stats(self) -> dict:
        s = self.allocator.stats()
        s["cache_bytes"] = self.cache_bytes()
        s["dense_bytes_equivalent"] = self.dense_bytes_equivalent()
        return s
