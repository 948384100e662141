"""Continuous-batching scheduler: admit and retire between decode steps.

A copy of ``repro/serve/scheduler.py``. The decode step runs over
fixed-capacity *slot lanes* — ``(capacity,)`` host arrays of token /
position / active plus the per-sequence sampling lanes from
serve/session.py. Admitting a request fills a free slot's lanes; retiring
zeroes them. The step's shapes never change while batch composition
churns.

Admission policy: strict FIFO with block-reservation backpressure. A
request needs ``ceil((len(prompt) + max_new_tokens) / block_size)``
cache blocks for its worst case; it is admitted only when a slot is
free AND the allocator can reserve that many blocks up front. If the
queue head does not fit, admission stops (no skip-ahead) — the request
stays queued, never dropped, and is retried every step as retirements
return blocks. Reserving the worst case at admission means an admitted
request can never hit an out-of-blocks condition mid-stream.

Every lane is a host numpy array mutated only at admit/retire
boundaries and uploaded once per step; per-slot computations in the
step are batch-row-independent, so a surviving sequence's logits are
bit-for-bit unchanged by its neighbours coming and going (tested in
tests/test_torch_serve.py).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from .kv_cache import BlockAllocator, blocks_for
from .session import Request


class SlotLanes:
    """The per-slot device-step inputs, host-side."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.token = np.zeros((capacity,), np.int32)
        self.pos = np.zeros((capacity,), np.int32)
        self.active = np.zeros((capacity,), bool)
        self.done = np.zeros((capacity,), bool)
        self.temperature = np.zeros((capacity,), np.float32)
        self.top_k = np.zeros((capacity,), np.int32)
        self.top_p = np.ones((capacity,), np.float32)
        self.key = np.zeros((capacity,), np.uint64)    # the request's seed
        self.eos = np.full((capacity,), -1, np.int32)

    def clear(self, slot: int) -> None:
        self.token[slot] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        self.done[slot] = False
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.key[slot] = 0
        self.eos[slot] = -1

    def fill(self, slot: int, req: Request) -> None:
        sp = req.sampling
        self.token[slot] = 0
        self.pos[slot] = 0
        self.active[slot] = True
        self.done[slot] = False
        self.temperature[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p
        self.key[slot] = sp.key_data()
        self.eos[slot] = -1 if req.eos_id is None else req.eos_id


class Scheduler:
    """FIFO admission + slot lifecycle over a shared block allocator."""

    def __init__(self, capacity: int, allocator: BlockAllocator, *,
                 max_blocks_per_seq: int):
        self.capacity = capacity
        self.allocator = allocator
        self.max_blocks_per_seq = max_blocks_per_seq
        self.lanes = SlotLanes(capacity)
        self.pending: deque[Request] = deque()
        self.running: dict[int, Request] = {}      # slot -> request
        self._free_slots: list[int] = list(range(capacity))
        self._generated: dict[int, int] = {}       # slot -> tokens emitted

    # -- queries ----------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.running)

    def slot_of(self, request_id: str) -> Optional[int]:
        for slot, req in self.running.items():
            if req.request_id == request_id:
                return slot
        return None

    def blocks_needed(self, req: Request) -> int:
        return blocks_for(len(req.prompt) + req.max_new_tokens,
                          self.allocator.block_size)

    def blocked_reason(self) -> Optional[str]:
        """Why the queue head is not admitted right now: ``"slots"`` (no
        free slot lane), ``"blocks"`` (pool cannot reserve its worst
        case), or None when the queue is empty / admission would proceed.
        Called after ``admit_ready`` drained what fits, this is the
        backpressure cause for this step."""
        if not self.pending:
            return None
        if not self._free_slots:
            return "slots"
        head = self.pending[0]
        if not self.allocator.can_alloc(len(head.prompt)
                                        + head.max_new_tokens):
            return "blocks"
        return None

    # -- lifecycle --------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        need = self.blocks_needed(req)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"request {req.request_id!r} needs {need} blocks, over the "
                f"per-sequence limit {self.max_blocks_per_seq}")
        if need > self.allocator.num_blocks:
            raise ValueError(
                f"request {req.request_id!r} needs {need} blocks, pool has "
                f"{self.allocator.num_blocks} total")
        self.pending.append(req)

    def admit_ready(self) -> list[tuple[int, Request]]:
        """Admit queue-head requests while a slot and blocks are free.
        Reserves the request's worst-case blocks and fills its slot
        lanes; the engine then prefills and sets token/pos."""
        admitted = []
        while (self.pending and self._free_slots
               and self.allocator.can_alloc(
                   len(self.pending[0].prompt)
                   + self.pending[0].max_new_tokens)):
            req = self.pending.popleft()
            slot = self._free_slots.pop(0)
            self.allocator.alloc(req.request_id,
                                 len(req.prompt) + req.max_new_tokens)
            self.lanes.fill(slot, req)
            self.running[slot] = req
            self._generated[slot] = 0
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int) -> Request:
        """Free the slot's blocks and lanes; returns the request."""
        req = self.running.pop(slot)
        self.allocator.free(req.request_id)
        self.lanes.clear(slot)
        self._generated.pop(slot)
        self._free_slots.append(slot)
        self._free_slots.sort()
        return req

    def drop_pending(self, request_id: str) -> bool:
        """Remove a queued (not yet admitted) request."""
        for req in self.pending:
            if req.request_id == request_id:
                self.pending.remove(req)
                return True
        return False

    def note_token(self, slot: int) -> int:
        """Count one emitted token for ``slot``; returns the new total."""
        self._generated[slot] += 1
        return self._generated[slot]

    def generated(self, slot: int) -> int:
        return self._generated[slot]
