"""The port's block allocator, paged cache and scheduler: the cases of
``tests/test_kv_cache.py`` on the port's classes, and random operation
sequences run through the port and the JAX package side by side."""
import numpy as np
import pytest
import torch

from repro.serve import kv_cache as jkv
from repro.serve import scheduler as jsched
from repro.serve import session as jsession
from repro_torch.configs.registry import get_config
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import session as tsession
from repro_torch.serve.kv_cache import (BlockAllocator, OutOfBlocksError,
                                        PagedCacheConfig, PagedKVCache,
                                        blocks_for, paged_supported)


def test_blocks_for():
    assert [blocks_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    assert all(blocks_for(n, bs) == jkv.blocks_for(n, bs)
               for n in range(40) for bs in (1, 3, 8))


def test_alloc_free_roundtrip():
    a = BlockAllocator(num_blocks=8, block_size=4)
    t = a.alloc("a", 10)            # 3 blocks
    assert len(t) == 3 and a.free_blocks == 5
    assert a.length("a") == 10
    assert a.free("a") == 3
    assert a.free_blocks == 8


def test_block_reuse_after_free_is_fifo():
    a = BlockAllocator(num_blocks=4, block_size=4)
    assert a.alloc("a", 8) == [0, 1] and a.alloc("b", 8) == [2, 3]
    a.free("a")
    assert a.alloc("c", 8) == [0, 1]
    a.free("b")
    a.free("c")
    assert a.alloc("d", 16) == [2, 3, 0, 1]


def test_out_of_blocks_raises_and_can_alloc_guards():
    a = BlockAllocator(num_blocks=2, block_size=4)
    a.alloc("a", 8)
    assert not a.can_alloc(1)
    with pytest.raises(OutOfBlocksError):
        a.alloc("b", 1)
    assert a.free_blocks == 0 and "b" not in a._tables
    a.free("a")
    assert a.can_alloc(8)


def test_extend_grows_and_backpressures():
    a = BlockAllocator(num_blocks=3, block_size=4)
    a.alloc("a", 4)
    fresh = a.extend("a", 9)
    assert len(fresh) == 2 and a.length("a") == 9
    assert a.extend("a", 10) == []
    with pytest.raises(OutOfBlocksError):
        a.extend("a", 13)
    assert a.free_blocks == 0 and len(a.table("a")) == 3


def test_double_alloc_rejected():
    a = BlockAllocator(num_blocks=4, block_size=4)
    a.alloc("a", 4)
    with pytest.raises(ValueError):
        a.alloc("a", 4)


def test_stats_utilization_fragmentation():
    a = BlockAllocator(num_blocks=8, block_size=8)
    a.alloc("a", 9)
    s = a.stats()
    assert s["used_blocks"] == 2 and s["free_blocks"] == 6
    assert s["held_tokens"] == 9
    assert s["utilization"] == pytest.approx(9 / 16)
    assert s["fragmentation"] == pytest.approx(1 - 9 / 16)
    a.free("a")
    s = a.stats()
    assert s["utilization"] == 0.0 and s["fragmentation"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_on_random_operations(seed):
    """The same alloc / extend / free sequence through both allocators:
    identical tables, lengths, errors and stats after every operation."""
    rng = np.random.default_rng(seed)
    pa = BlockAllocator(num_blocks=12, block_size=4)
    ja = jkv.BlockAllocator(num_blocks=12, block_size=4)
    live = []
    for i in range(60):
        op = int(rng.integers(3)) if live else 0
        n = int(rng.integers(1, 20))
        pick = live[int(rng.integers(len(live)))] if live else None
        results = []
        for a, err in ((pa, OutOfBlocksError), (ja, jkv.OutOfBlocksError)):
            try:
                if op == 0:
                    results.append(a.alloc(f"s{i}", n))
                elif op == 1:
                    results.append(a.extend(pick, a.length(pick) + n % 9))
                else:
                    results.append(a.free(live[0]))
            except err:
                results.append("out of blocks")
        assert results[0] == results[1]
        if results[0] != "out of blocks":
            if op == 0:
                live.append(f"s{i}")
            elif op == 2:
                live.pop(0)
        assert pa.stats() == ja.stats()
        assert {s: pa.table(s) for s in live} == {s: ja.table(s) for s in live}


def test_scheduler_matches_jax_admission():
    """FIFO admission with block-reservation backpressure, slot reuse and
    retirement give the same slots, lanes and blocked reasons in both."""
    def make(mod_sched, mod_kv):
        return mod_sched.Scheduler(3, mod_kv.BlockAllocator(10, 4),
                                   max_blocks_per_seq=6)

    ts, js = make(tsched, tkv), make(jsched, jkv)
    rng = np.random.default_rng(0)
    reqs = [(f"r{i}", rng.integers(0, 50, int(rng.integers(2, 12))),
             int(rng.integers(1, 8))) for i in range(8)]
    for rid, prompt, new in reqs:
        ts.enqueue(tsession.Request(rid, prompt, max_new_tokens=new))
        js.enqueue(jsession.Request(rid, prompt, max_new_tokens=new))
    for _ in range(6):
        got = [(s, r.request_id) for s, r in ts.admit_ready()]
        want = [(s, r.request_id) for s, r in js.admit_ready()]
        assert got == want
        assert ts.blocked_reason() == js.blocked_reason()
        for lane in ("token", "pos", "active", "temperature", "top_k",
                     "top_p", "eos"):
            np.testing.assert_array_equal(getattr(ts.lanes, lane),
                                          getattr(js.lanes, lane))
        if ts.running:
            slot = min(ts.running)
            assert ts.retire(slot).request_id == js.retire(slot).request_id
        assert ts.allocator.stats() == js.allocator.stats()
    assert ts.drop_pending(reqs[-1][0]) == js.drop_pending(reqs[-1][0])
    with pytest.raises(ValueError, match="per-sequence limit"):
        ts.enqueue(tsession.Request("big", np.ones(30), max_new_tokens=1))


def test_paged_cache_table_and_sizing():
    cfg = get_config("llama-350m", smoke=True)
    cc = PagedCacheConfig(block_size=4, num_blocks=16, max_blocks_per_seq=4)
    cache = PagedKVCache(cfg, cc, num_slots=2, device="cpu")
    assert set(cache.pools) == {"segments/0/p0/k", "segments/0/p0/v"}
    for leaf in cache.pools.values():
        assert leaf.shape == (1, 16, 4, cfg.n_kv_heads, cfg.hd)
    cache.allocator.alloc("r", 6)
    cache.bind_slot(1, "r")
    tab = cache.block_table()
    assert tab.dtype == torch.int32 and tab.shape == (2, 4)
    assert (tab[0] == 0).all()
    assert tab[1, :2].tolist() == cache.allocator.table("r")
    cache.clear_slot(1)
    assert (cache.block_table() == 0).all()
    assert tab[1, :2].tolist() == cache.allocator.table("r")   # a snapshot
    assert cache.cache_bytes() == 2 * 16 * 4 * cfg.n_kv_heads * cfg.hd * 4
    assert cache.dense_bytes_equivalent() == \
        2 * cfg.n_kv_heads * cfg.hd * 4 * 2 * cc.max_seq_len
    s = cache.stats()
    assert s["cache_bytes"] == cache.cache_bytes()


def test_paged_cache_rejects_unpaged_and_unported_kinds():
    cfg = get_config("llama-350m", smoke=True)
    assert paged_supported(cfg)
    cc = PagedCacheConfig(block_size=4, num_blocks=8, max_blocks_per_seq=2)
    mla = cfg.__class__(**{**cfg.__dict__,
                           "schedule": ((("mla_dense",), 1),)})
    assert not paged_supported(mla)
    with pytest.raises(ValueError, match="paged"):
        PagedKVCache(mla, cc, num_slots=1, device="cpu")
    local = cfg.__class__(**{**cfg.__dict__, "schedule": ((("local",), 1),)})
    assert paged_supported(local)
    assert set(PagedKVCache(local, cc, num_slots=1, device="cpu").pools) == {
        "segments/0/p0/k", "segments/0/p0/v"}
    moe = cfg.__class__(**{**cfg.__dict__, "schedule": ((("attn_moe",), 1),)})
    assert paged_supported(moe)
    assert set(PagedKVCache(moe, cc, num_slots=1, device="cpu").pools) == {
        "segments/0/p0/k", "segments/0/p0/v"}
    rwkv = cfg.__class__(**{**cfg.__dict__, "schedule": ((("rwkv",), 1),)})
    assert not paged_supported(rwkv)
    with pytest.raises(ValueError, match="paged"):
        PagedKVCache(rwkv, cc, num_slots=1, device="cpu")
