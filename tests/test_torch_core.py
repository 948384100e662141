"""Core math of the port against the JAX package on the same numpy inputs:
DCT bases and Makhoul's FFT transform, dynamic column selection (including
the tie-breaking of top-r), the q8 error-feedback quantizer, projector and
rotation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dct as jdct
from repro.core import error_feedback as jef
from repro.core import projectors as jproj
from repro.core import selection as jsel
from repro_torch.core import dct as tdct
from repro_torch.core import error_feedback as tef
from repro_torch.core import projectors as tproj
from repro_torch.core import selection as tsel


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [1, 8, 17, 64, 1024])
def test_dct_matrices_match_jax(n):
    # atol 1e-6: both build entries from the same exact int32 phase and an
    # fp32 cosine; the two libraries' cosines differ by at most an ulp
    np.testing.assert_allclose(tdct.dct3_matrix(n).numpy(),
                               np.asarray(jdct.dct3_matrix(n)), atol=1e-6)
    np.testing.assert_allclose(tdct.dct2_matrix(n).numpy(),
                               np.asarray(jdct.dct2_matrix(n)), atol=1e-6)
    assert tdct.dct2_matrix(n).is_contiguous()


@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 17), (2, 64), (6, 1024)])
def test_makhoul_dct2_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x /= np.sqrt(shape[-1])
    got = tdct.makhoul_dct2(_t(x)).numpy()
    # atol 1e-6 on unit-scale outputs: two FFT libraries, fp32 butterflies
    np.testing.assert_allclose(got, np.asarray(jdct.makhoul_dct2(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(got, x @ tdct.dct2_matrix(shape[-1]).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("case", ["all_equal", "pairs", "blocks", "stacked"])
def test_select_top_r_ties_match_jax(case):
    """lax.top_k puts the lower index first among equal values; the port's
    stable descending sort must pick exactly the same indices."""
    rng = np.random.default_rng(2)
    if case == "all_equal":
        norms = np.ones((16,), np.float32)
    elif case == "pairs":
        norms = np.repeat(rng.standard_normal(8).astype(np.float32), 2)
        rng.shuffle(norms)
    elif case == "blocks":
        norms = np.array([3, 1, 2, 2, 2, 5, 2, 1, 5, 0, 2, 3], np.float32)
    else:
        norms = rng.integers(0, 4, size=(3, 5, 24)).astype(np.float32)
    for r in (1, 3, 7, norms.shape[-1]):
        want = np.asarray(jsel.select_top_r(jnp.asarray(norms), r))
        got = tsel.select_top_r(_t(norms), r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        want_u = np.asarray(jsel.select_top_r(jnp.asarray(norms), r, sort=False))
        np.testing.assert_array_equal(
            tsel.select_top_r(_t(norms), r, sort=False).numpy(), want_u)


@pytest.mark.parametrize("ord", ["l1", "l2"])
def test_column_selection_matches_jax(ord):
    rng = np.random.default_rng(3)
    s = rng.standard_normal((2, 12, 20)).astype(np.float32)
    np.testing.assert_allclose(tsel.column_norms(_t(s), ord).numpy(),
                               np.asarray(jsel.column_norms(jnp.asarray(s), ord)),
                               rtol=1e-6)
    ji, jb = jsel.dynamic_column_selection(jnp.asarray(s), 5, ord=ord)
    ti, tb = tsel.dynamic_column_selection(_t(s), 5, ord=ord)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_gather_and_back_projections_match_jax():
    rng = np.random.default_rng(4)
    q = np.asarray(jdct.dct2_matrix(16))
    idx = np.stack([np.sort(rng.permutation(16)[:5]) for _ in range(3)]
                   ).astype(np.int32)
    b1 = rng.standard_normal((3, 7, 5)).astype(np.float32)
    b2 = rng.standard_normal((3, 7, 5)).astype(np.float32)
    jq, ji = jnp.asarray(q), jnp.asarray(idx)
    np.testing.assert_array_equal(tsel.gather_columns(_t(q), _t(idx)).numpy(),
                                  np.asarray(jsel.gather_columns(jq, ji)))
    # rtol 1e-6: the same fp32 products summed in the libraries' own orders
    np.testing.assert_allclose(
        tsel.back_project(_t(b1), _t(q), _t(idx)).numpy(),
        np.asarray(jsel.back_project(jnp.asarray(b1), jq, ji)),
        rtol=1e-6, atol=1e-6)
    for got, want in zip(tsel.dual_back_project(_t(b1), _t(b2), _t(q), _t(idx)),
                         jsel.dual_back_project(jnp.asarray(b1),
                                                jnp.asarray(b2), jq, ji)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_overlap_and_margin_match_jax():
    rng = np.random.default_rng(5)
    a = np.sort(rng.permutation(20)[:6]).astype(np.int32)
    b = np.sort(rng.permutation(20)[:6]).astype(np.int32)
    np.testing.assert_allclose(
        tsel.index_overlap(_t(a), _t(b)).numpy(),
        np.asarray(jsel.index_overlap(jnp.asarray(a), jnp.asarray(b))))
    norms = rng.random((2, 20)).astype(np.float32)
    for r in (3, 20):
        np.testing.assert_allclose(
            tsel.topr_margin(_t(norms), r).numpy(),
            np.asarray(jsel.topr_margin(jnp.asarray(norms), r)), rtol=1e-6)


def _q8_input(shape):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    x[..., 0, :] = 0.0                 # all-zero row
    x[..., 1, :] = 1e-40               # subnormal row: the F32_TINY clamp
    x[..., 2, :] = np.float32(127.0) * np.arange(shape[-1]) / 2  # .5 ties
    return x


@pytest.mark.parametrize("shape", [(4, 9), (2, 5, 33)])
def test_quantize_q8_matches_jax(shape):
    x = _q8_input(shape)
    jb = jef.quantize_q8(jnp.asarray(x))
    tb = tef.quantize_q8(_t(x))
    np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))
    # |dq| <= 1: the payload is round(x / scale) with an IEEE division and
    # round-half-to-even in both; a one-unit flip is the most an ulp could do
    assert np.abs(tb.q.numpy().astype(int) - np.asarray(jb.q).astype(int)).max() <= 1
    assert np.isfinite(tb.scale.numpy()).all()
    # zero and subnormal rows: scale clamped to F32_TINY, payload all zero
    assert (tb.q[..., :2, :] == 0).all()
    assert (tb.scale[..., :2, 0] == np.finfo(np.float32).tiny).all()
    np.testing.assert_array_equal(
        tef.dequantize_q8(tb).numpy(),
        np.asarray(jef.dequantize_q8(jef.QuantizedBuffer(
            q=jnp.asarray(tb.q.numpy()), scale=jnp.asarray(tb.scale.numpy())))))
    z = tef.zeros_q8((3, 4), (2,))
    assert z.q.shape == (2, 3, 4) and z.scale.shape == (2, 3, 1)


@pytest.mark.parametrize("exact", [False, True])
def test_projector_and_rotation_match_jax(exact):
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 24, 16)).astype(np.float32)
    q = np.asarray(jdct.dct2_matrix(16))
    jp = jproj.Projector(kind="dct", r=4)
    tp = tproj.Projector(kind="dct", r=4)
    j0 = jp.init(g.shape)
    t0 = tp.init(g.shape)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    j1 = jp.update(jnp.asarray(g), j0, shared_q=jnp.asarray(q))
    t1 = tp.update(_t(g), t0, shared_q=_t(q))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_allclose(
        tp.project(_t(g), t1, shared_q=_t(q)).numpy(),
        np.asarray(jp.project(jnp.asarray(g), j1, shared_q=jnp.asarray(q))),
        rtol=1e-5, atol=1e-6)
    rot_t = tproj.rotation_matrix(t0, t1, tp, 16, shared_q=_t(q),
                                  exact_matmul=exact)
    rot_j = jproj.rotation_matrix(j0, j1, jp, 16, shared_q=jnp.asarray(q),
                                  exact_matmul=exact)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-6)


def test_unported_kinds_raise():
    tproj.Projector(kind="svd", r=4)               # the dense kinds build
    with pytest.raises(ValueError, match="unknown projector kind"):
        tproj.Projector(kind="wavelet", r=4)
    # the ZeRO-1 collectives are ported: a shard axis needs an active mesh
    with pytest.raises(RuntimeError, match="active mesh"):
        tsel.allsum(torch.zeros(2), ("data",))


def test_shared_basis_is_built_once():
    from repro_torch.core.transforms import basis_cache, shared_basis
    cache = basis_cache()
    a = shared_basis("dct", 12)
    hits = cache.hits
    assert shared_basis("dct", 12) is a and cache.hits == hits + 1
    np.testing.assert_allclose(a.numpy(), np.asarray(jdct.dct2_matrix(12)),
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 8, 17, 64])
def test_dct_basis_np_equals_jax(n):
    got = tdct.dct_basis_np(n)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jdct.dct_basis_np(n))


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 17), (6, 64)])
def test_dct2_matches_jax(method, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jdct.dct2(jnp.asarray(x), method=method))
    got = tdct.dct2(_t(x), method=method)
    assert got.dtype == torch.float32 and got.shape == x.shape
    # atol 1e-5 of the largest entry: fp32 sums (or FFT butterflies) in
    # another order than JAX's
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown method"):
        tdct.dct2(_t(x), method="dst")
