"""Serving: the paged continuous-batching engine with the ``flash_decode``
CUDA kernel, and the dense fixed-batch engine. The port of ``repro.serve``
with the same public names."""
from .engine import PagedServeEngine, ServeEngine, make_serve_step
from .kv_cache import (BlockAllocator, OutOfBlocksError, PagedCacheConfig,
                       PagedKVCache, blocks_for, paged_supported)
from .scheduler import Scheduler, SlotLanes
from .session import (GenerationHandle, Request, SamplingParams, Session,
                      sample_tokens)

__all__ = [
    "ServeEngine", "PagedServeEngine", "make_serve_step",
    "BlockAllocator", "OutOfBlocksError", "PagedCacheConfig", "PagedKVCache",
    "blocks_for", "paged_supported", "Scheduler", "SlotLanes",
    "GenerationHandle", "Request", "SamplingParams", "Session",
    "sample_tokens",
]
