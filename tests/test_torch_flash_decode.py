"""The port's ``flash_decode`` on CPU tensors (its plain version) against the
JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

The cases of ``tests/test_flash_decode.py``: GQA group sizes including MHA
and 8q/1kv, odd head dims, every fill level of the last block, caches
longer than one split with 1-6 splits, sliding windows, and inactive
(length-0) rows that are exactly zero and isolated from stale table
entries. fp32 throughout; atol = rtol = 2e-6 (sums over the same keys in
another order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro_torch.kernels import ops
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
fd = importlib.import_module("repro_torch.kernels.flash_decode")

TOL = dict(atol=2e-6, rtol=2e-6)


def _case(rng, *, b, hq, hkv, hd, num_blocks, bs, maxb, lengths):
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    k = rng.standard_normal((num_blocks, bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, hkv, hd)).astype(np.float32)
    # distinct blocks per row, padded with zeros past each row's need
    table = np.zeros((b, maxb), np.int32)
    free = list(rng.permutation(num_blocks))
    for i, ln in enumerate(lengths):
        need = -(-ln // bs)
        table[i, :need] = [free.pop() for _ in range(need)]
    return q, k, v, table, np.asarray(lengths, np.int32)


def _both(args, **kw):
    """(port on CPU, JAX interpret) outputs as numpy."""
    before = ops.launch_counts(ops.SERVING)
    got = fd.flash_decode(*(torch.from_numpy(a) for a in args), **kw)
    assert ops.launch_counts(ops.SERVING) == before   # CPU: plain version
    want = jax_flash_decode(*(jnp.asarray(a) for a in args), interpret=True,
                            **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1), (6, 3)])
def test_gqa_group_sizes(hq, hkv):
    args = _case(np.random.default_rng(0), b=3, hq=hq, hkv=hkv, hd=16,
                 num_blocks=24, bs=8, maxb=4, lengths=[17, 32, 9])
    np.testing.assert_allclose(*_both(args), **TOL)


@pytest.mark.parametrize("hd", [17, 31])
def test_odd_head_dims(hd):
    args = _case(np.random.default_rng(1), b=2, hq=4, hkv=2, hd=hd,
                 num_blocks=16, bs=8, maxb=3, lengths=[11, 24])
    np.testing.assert_allclose(*_both(args), **TOL)


@pytest.mark.parametrize("length", [1, 7, 8, 9, 15, 16])
def test_partial_final_blocks(length):
    args = _case(np.random.default_rng(2), b=1, hq=4, hkv=2, hd=16,
                 num_blocks=8, bs=8, maxb=2, lengths=[length])
    np.testing.assert_allclose(*_both(args), **TOL)


@pytest.mark.parametrize("num_splits", [1, 2, 3, 6])
def test_split_kv_merge(num_splits):
    args = _case(np.random.default_rng(3), b=2, hq=4, hkv=2, hd=16,
                 num_blocks=16, bs=4, maxb=6, lengths=[23, 10])
    np.testing.assert_allclose(*_both(args, num_splits=num_splits), **TOL)


@pytest.mark.parametrize("window", [4, 8])
def test_sliding_window(window):
    args = _case(np.random.default_rng(4), b=2, hq=4, hkv=4, hd=16,
                 num_blocks=12, bs=4, maxb=5, lengths=[19, 6])
    np.testing.assert_allclose(*_both(args, window=window, num_splits=2),
                               **TOL)


def test_inactive_rows_zero_and_isolated():
    q, k, v, table, lengths = _case(
        np.random.default_rng(5), b=3, hq=4, hkv=2, hd=16, num_blocks=16,
        bs=8, maxb=3, lengths=[13, 0, 21])
    got, want = _both((q, k, v, table, lengths), num_splits=2)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()
    # poison the inactive row's table and the blocks no row reaches: the
    # active rows are unchanged
    poisoned = table.copy()
    poisoned[1] = [5, 6, 7]
    k2, v2 = k.copy(), v.copy()
    unused = sorted(set(range(16)) - set(table[[0, 2]].ravel()))
    k2[unused] = np.nan
    v2[unused] = np.nan
    got2 = fd.flash_decode(*(torch.from_numpy(a) for a in
                             (q, k2, v2, poisoned, lengths)), num_splits=2)
    np.testing.assert_array_equal(got[[0, 2]], got2.numpy()[[0, 2]])
    assert not got2.numpy()[1].any()


def test_matches_dense_decode_attention_order():
    args = _case(np.random.default_rng(6), b=4, hq=8, hkv=4, hd=32,
                 num_blocks=32, bs=8, maxb=4, lengths=[32, 1, 17, 25])
    np.testing.assert_allclose(*_both(args), **TOL)


def test_merge_splits_is_the_one_pass_softmax():
    """Splitting the walk and merging the partials gives the single-split
    result, and an all-empty row merges to exactly 0."""
    args = _case(np.random.default_rng(7), b=2, hq=4, hkv=2, hd=16,
                 num_blocks=16, bs=4, maxb=6, lengths=[23, 0])
    t = [torch.from_numpy(a) for a in args]
    one = fd.flash_decode_plain(*t, num_splits=1)
    for splits in (2, 4, 6, 9):                # 9 clamps to MAXB = 6
        many = fd.flash_decode_plain(*t, num_splits=splits)
        torch.testing.assert_close(many, one, **TOL)
        assert not many[1].any()


def test_bf16_pools_and_query():
    """bf16 q and pools: fp32 arithmetic inside, output in q's dtype, within
    one bf16 rounding of the JAX kernel on the same bf16 values."""
    args = _case(np.random.default_rng(8), b=2, hq=4, hkv=2, hd=16,
                 num_blocks=12, bs=4, maxb=5, lengths=[19, 6])
    q, k, v, table, lengths = args
    got = fd.flash_decode(torch.from_numpy(q).bfloat16(),
                          torch.from_numpy(k).bfloat16(),
                          torch.from_numpy(v).bfloat16(),
                          torch.from_numpy(table), torch.from_numpy(lengths),
                          num_splits=2)
    want = jax_flash_decode(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(table),
                            jnp.asarray(lengths), num_splits=2,
                            interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_rejects_bad_shapes():
    q, k, v, table, lengths = (torch.from_numpy(a) for a in _case(
        np.random.default_rng(9), b=2, hq=4, hkv=3, hd=16, num_blocks=8,
        bs=4, maxb=2, lengths=[3, 5]))
    with pytest.raises(ValueError, match="do not fit"):
        fd.flash_decode(q, k, v, table, lengths)       # 4 % 3 != 0
    with pytest.raises(ValueError, match="window"):
        fd.flash_decode(q[:, :3], k, v, table, lengths, window=0)


# ---------------------------------------------------------------------------
# the kernel's cut of the table (host-side planning, run on the CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("maxb,bs,splits", [
    (128, 16, 1), (128, 16, 2), (128, 16, 16), (128, 16, 128),
    (130, 16, 2), (256, 8, 3), (64, 32, 5), (3, 40, 2), (40, 1, 3),
    (6, 4, 9), (1, 256, 4)])
def test_plan_ranges_tiles_each_split(maxb, bs, splits):
    """The ranges cut every caller split into pieces of about RANGE_TOKENS
    tokens that cover each table column exactly once, in column order."""
    n, bps, cols, per_split = fd.plan_ranges(maxb, bs, splits)
    assert n == max(1, min(splits, maxb)) and bps == -(-maxb // n)
    assert cols == 1 or cols * bs <= fd.RANGE_TOKENS
    assert cols <= bps and per_split * cols >= bps
    covered = []
    for p in range(n * per_split):
        s, j = divmod(p, per_split)
        lo = s * bps + j * cols
        hi = min(lo + cols, (s + 1) * bps, maxb)
        covered.extend(range(lo, hi))       # empty past the table
    assert covered == list(range(maxb))


def test_plan_ranges_do_not_follow_the_split_count():
    """At the serving shape every split count gives the same 16 ranges of
    8 blocks: the kernel's parallelism does not depend on it."""
    for splits in (1, 2, 4, 8, 16):
        n, bps, cols, per_split = fd.plan_ranges(128, 16, splits)
        assert (cols, n * per_split) == (8, 16)


def _range_partials(q, k, v, table, lengths, window, bs, plan):
    """The kernel's decomposition in plain PyTorch: one masked partial per
    live range (a valid token in its columns), merged in range order."""
    n, bps, cols, per_split = plan
    b, hq, hd = q.shape
    hkv = k.shape[2]
    kd = k[table.long()].reshape(b, -1, hkv, hd)
    vd = v[table.long()].reshape(b, -1, hkv, hd)
    qg = q.reshape(b, hkv, hq // hkv, hd)
    rows = []
    for i in range(b):
        length = int(lengths[i])
        first = length - window if window else -2**31
        parts = []
        for p in range(n * per_split):
            s, j = divmod(p, per_split)
            lo = s * bps + j * cols
            hi = min(lo + cols, (s + 1) * bps, table.shape[1])
            if not (lo < hi and lo * bs < length and hi * bs > first):
                continue
            keys = range(max(lo * bs, first, 0), min(hi * bs, length))
            sc = torch.einsum("hgd,shd->hgs", qg[i], kd[i, keys]) / hd ** 0.5
            m = sc.amax(-1, keepdim=True)
            e = torch.exp(sc - m)
            parts.append((torch.einsum("hgs,shd->hgd", e, vd[i, keys]), m,
                          e.sum(-1, keepdim=True)))
        if not parts:
            rows.append(torch.zeros(hq, hd))
            continue
        o, m, l = (torch.stack(t) for t in zip(*parts))
        rows.append(fd.merge_splits(o, m, l).reshape(hq, hd))
    return torch.stack(rows)


@pytest.mark.parametrize("window", [None, 1, 7, 40])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_range_partials_merge_to_the_function(window, splits, monkeypatch):
    """Merging the live ranges' partials (dead ranges skipped, as the merge
    kernel skips them) is the plain version's function: fp32 sums in
    another order, a length-0 slot exactly zero."""
    monkeypatch.setattr(fd, "RANGE_TOKENS", 8)     # ranges of 2 blocks of 4
    args = _case(np.random.default_rng(10), b=4, hq=6, hkv=2, hd=16,
                 num_blocks=40, bs=4, maxb=9, lengths=[33, 0, 1, 20])
    t = [torch.from_numpy(a) for a in args]
    plan = fd.plan_ranges(9, 4, splits)
    assert plan[2] == 2
    got = _range_partials(*t, window, 4, plan)
    want = fd.flash_decode_plain(*t, window=window, num_splits=splits)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[1].any()


def test_vector_path_needs_bf16_hd8_and_16_bytes():
    """The 16-byte path is chosen for bf16 pools with hd % 8 == 0 on 16
    bytes (the serving and gemma3 shapes); fp32 pools, odd head dims and
    an offset view take the scalar path."""
    def pool(hd, dtype=torch.bfloat16):
        return torch.zeros(4, 16, 2, hd, dtype=dtype)
    assert fd.vector_path(pool(64), pool(64))
    assert fd.vector_path(pool(128), pool(128))
    assert not fd.vector_path(pool(64, torch.float32), pool(64, torch.float32))
    assert not fd.vector_path(pool(17), pool(17))
    flat = torch.zeros(1 + 4 * 16 * 2 * 64, dtype=torch.bfloat16)
    shifted = flat[1:].view(4, 16, 2, 64)
    assert not fd.vector_path(shifted, pool(64))
