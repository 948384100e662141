"""The int8 ``dct_project``'s route on the CPU against the JAX package: its
operand quantizers (``quant_rows_q8`` of G, ``quant_cols_q8t`` of Q with the
codes written as ``Q^T``'s) against ``lowp.quant_rows`` / ``quant_cols`` of
both packages, codes and scales bit for bit, and the product on ``Q^T``'s
codes (``dct_project_q8t``) against the Pallas kernel in interpret mode
given JAX's codes, bit for bit.

JAX's quantizers are compared run eagerly: there they divide by 127 as
IEEE does, as the port does; under jit XLA multiplies by the reciprocal
(``tests/test_torch_lowp.py`` holds that case to an ulp). The Pallas kernel
quantizes under jit, so the product is compared given JAX's own codes.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dct import dct2_matrix as jax_dct2
from repro.kernels import lowp as jl
from repro_torch.kernels import lowp as tl
from repro_torch.kernels import ops
from repro_torch.kernels import quant_ef as tqe
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
tdp = importlib.import_module("repro_torch.kernels.dct_project")

jdp = importlib.import_module("repro.kernels.dct_project")

# (..., m, n) oriented gradients, as tests/test_torch_cuda.py's SHAPES: 2d,
# a layer-stacked leaf, odd sizes that are no tile multiple, and a row count
# past one 128-row tile
SHAPES = {"2d": (40, 24), "stacked": (3, 40, 24), "odd": (33, 17),
          "transposed": (48, 16), "tiles": (2, 300, 136)}
# the column norms: fp32 sums of squares in another order
NORM_RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _edge_rows(x: np.ndarray) -> np.ndarray:
    """A zero row, a subnormal row and a tiny (normal) one."""
    x = x.copy()
    x[..., 0, :] = 0.0
    x[..., 1, :] = 2e-45
    x[..., 2, :] *= 1e-30
    return x


@pytest.mark.parametrize("name", list(SHAPES))
def test_quant_rows_q8_matches_jax(name):
    x = _edge_rows(_rand(SHAPES[name], 1, scale=3.0))
    codes, scales = tqe.quant_rows_q8(torch.from_numpy(x))
    jq, js = jl.quant_rows(jnp.asarray(x))
    assert np.array_equal(codes.numpy(), np.asarray(jq))
    assert np.array_equal(scales.numpy(), np.asarray(js))
    want = tl.quant_rows(torch.from_numpy(x))
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
    assert not codes[..., :2, :].any()           # zero and subnormal rows
    assert (scales >= tl.F32_TINY).all()
    assert ops.launch_counts(ops.LOWP)["quant_rows_q8"] == 0     # CPU: plain


@pytest.mark.parametrize("name", list(SHAPES))
def test_quant_cols_q8t_is_quant_cols_transposed(name):
    """A (k, n) matrix with a zero, a subnormal and a tiny column: the
    codes are ``quant_cols``' transposed and contiguous, the scales equal,
    in the port and in JAX."""
    k, n = SHAPES[name][-2:]
    x = _edge_rows(_rand((n, k), 2, scale=3.0)).T.copy()
    codes, scales = tqe.quant_cols_q8t(torch.from_numpy(x))
    assert codes.shape == (n, k) and codes.is_contiguous()
    assert scales.shape == (1, n)
    want_q, want_s = tl.quant_cols(torch.from_numpy(x))
    assert torch.equal(codes, want_q.T) and torch.equal(scales, want_s)
    jq, js = jl.quant_cols(jnp.asarray(x))
    assert np.array_equal(codes.numpy(), np.asarray(jq).T)
    assert np.array_equal(scales.numpy(), np.asarray(js))
    assert not codes[:2].any()                   # zero and subnormal columns
    assert ops.launch_counts(ops.LOWP)["quant_cols_q8t"] == 0    # CPU: plain


@pytest.mark.parametrize("name", list(SHAPES))
def test_dct_project_q8t_bit_equal_given_jax_codes(name):
    shape = SHAPES[name]
    n = shape[-1]
    g = _edge_rows(_rand(shape, 3))
    q = np.array(jax_dct2(n))
    js, jn = jdp.dct_project(jnp.asarray(g), jnp.asarray(q), interpret=True,
                             compute_dtype="int8")
    gq, sg = jax.jit(jl.quant_rows)(jnp.asarray(g))
    qq, sq = jax.jit(jl.quant_cols)(jnp.asarray(q))
    qtq = _t(np.asarray(qq).T)
    s, norms = tdp.dct_project_q8t_plain(_t(gq), _t(sg), qtq, _t(sq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), rtol=NORM_RTOL)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    s2, norms2 = tdp.dct_project_q8t(_t(gq), _t(sg), qtq, _t(sq))
    assert torch.equal(s2, s) and torch.equal(norms2, norms)
    assert ops.launch_counts(ops.LOWP)["dct_project_q8"] == 0


@pytest.mark.parametrize("name", list(SHAPES))
def test_int8_route_equals_plain_on_cpu(name):
    """``dct_project(..., "int8")`` (the quantizers, then the product on
    ``Q^T``'s codes) equals ``dct_project_q8_plain`` on ``lowp``'s codes,
    and ``dct_project_q8`` on ``Q``'s codes equals both."""
    shape = SHAPES[name]
    g = torch.from_numpy(_edge_rows(_rand(shape, 4)))
    q = torch.from_numpy(np.array(jax_dct2(shape[-1])))
    s, norms = tdp.dct_project(g, q, compute_dtype="int8")
    gq, sg = tl.quant_rows(g)
    qq, sq = tl.quant_cols(q)
    want = tdp.dct_project_q8_plain(gq, sg, qq, sq)
    assert torch.equal(s, want[0]) and torch.equal(norms, want[1])
    got = tdp.dct_project_q8t(*tqe.quant_rows_q8(g), *tqe.quant_cols_q8t(q))
    assert torch.equal(got[0], s) and torch.equal(got[1], norms)
    got = tdp.dct_project_q8(gq, sg, qq, sq)
    assert torch.equal(got[0], s) and torch.equal(got[1], norms)


def test_q8t_wrappers_refuse():
    """Shapes that do not fit, a basis that is not a matrix, and a depth
    whose int32 sums could overflow (checked before any work: the operands
    are broadcast views)."""
    gq = torch.zeros(4, 16, dtype=torch.int8)
    sg, sq = torch.ones(4, 1), torch.ones(1, 16)
    qtq = torch.zeros(16, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not fit"):
        tdp.dct_project_q8t(gq, sg, qtq[:8], sq)
    with pytest.raises(ValueError, match="do not fit"):
        tdp.dct_project_q8t(gq, sg[:2], qtq, sq)
    with pytest.raises(ValueError, match="matrix"):
        tqe.quant_cols_q8t(torch.zeros(2, 4, 4))
    n = 2**31 // 127**2 + 1
    with pytest.raises(ValueError, match="overflow"):
        tdp.dct_project_q8t(torch.zeros(1, n, dtype=torch.int8),
                            torch.ones(1, 1),
                            torch.zeros((), dtype=torch.int8).expand(n, n),
                            torch.ones(()).expand(1, n))
