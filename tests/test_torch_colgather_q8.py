"""The int8 ``colgather_matmul``'s route on the CPU against the JAX package:
its operand quantizers (``quant_qt_q8`` of ``Q^T``, ``quant_fold_q8`` of
every ``b`` with the selected rows' scales folded in) against
``lowp.quant_rows`` as the JAX package's ``colgather_matmul`` applies it
(``repro/kernels/colgather_matmul.py:158-162``), the int8 dual and single
back-projections on the route's operands against the Pallas kernels in
interpret mode, and the wrappers' refusals.

JAX's quantizers run eagerly divide by 127 as IEEE does, as the port does:
codes and scales bit for bit. Under jit (inside the Pallas colgather) XLA
multiplies by the reciprocal, one ulp off the quotient in some rows
(ROADMAP queue 3), so there the scales are held within one ulp and the
codes within one, and the products (on codes that may differ in such a
row) within ``JIT_RTOL`` of max |out|; given JAX's own codes they are
bit-equal (``tests/test_torch_lowp.py``). The CUDA kernels are held to
these plain versions bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 10).
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
tcg = importlib.import_module("repro_torch.kernels.colgather_matmul")

jcg = importlib.import_module("repro.kernels.colgather_matmul")

# (b's (..., m, r), n): layer-stacked like llama's 24 layers (small), a
# ragged 2d factor, a rank that is no multiple of 4 or 32, r == n
CASES = {"stacked": ((24, 12, 16), 40), "ragged": ((33, 9), 23),
         "odd-rank": ((3, 20, 45), 64), "full-rank": ((2, 7, 17), 17)}
# the products on the route's operands against the Pallas kernel, whose
# operands were quantized under jit: scales an ulp apart move an output by
# about an ulp (at most 2.3e-7 of max |out| at these cases), a code one off
# by more; tests/test_torch_lowp.py's bar for the same comparison
JIT_RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _idx(batch, n, r, seed):
    rng = np.random.default_rng(seed)
    out = np.stack([np.sort(rng.permutation(n)[:r])
                    for _ in range(int(np.prod(batch, dtype=int)))])
    return out.reshape(*batch, r).astype(np.int32)


def _operands(name):
    """b1, b2 (rows 0-2 of b1: zero, subnormal, tiny), Q^T, idx."""
    (*batch, m, r), n = CASES[name]
    b1 = _rand((*batch, m, r), 1, scale=3.0)
    b1[..., 0, :] = 0.0
    b1[..., 1, :] = 2e-45
    b1[..., 2, :] *= 1e-30
    b2 = _rand((*batch, m, r), 2)
    qt = np.ascontiguousarray(np.array(jax_dct2(n)).T)
    return b1, b2, qt, _idx(batch, n, r, 3)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _jax_operands(bs, qt, idx):
    """The JAX package's colgather quantization (colgather_matmul.py:158-162)."""
    qt_q, s_qt = jl.quant_rows(qt)
    s_sel = jnp.take(s_qt[:, 0], idx, axis=0)
    return qt_q, s_qt, [jl.quant_rows(b.astype(jnp.float32) * s_sel[..., None, :])
                        for b in bs]


@pytest.mark.parametrize("name", list(CASES))
def test_quantizers_match_jax_eager(name):
    """quant_qt_q8 and quant_fold_q8 (plain on the CPU) equal JAX's eager
    quant_rows of Q^T and of each b with the selected scales folded in,
    codes and scales bit for bit; the zero and subnormal rows quantize to
    zero codes with the F32_TINY scale."""
    b1, b2, qt, idx = _operands(name)
    jq, js, jops = _jax_operands([jnp.asarray(b1), jnp.asarray(b2)],
                                 jnp.asarray(qt), jnp.asarray(idx))
    qt_q, s_qt = tqe.quant_qt_q8(torch.from_numpy(qt))
    assert np.array_equal(qt_q.numpy(), np.asarray(jq))
    assert np.array_equal(s_qt.numpy(), np.asarray(js))
    folded = tqe.quant_fold_q8((torch.from_numpy(b1), torch.from_numpy(b2)),
                               s_qt, torch.from_numpy(idx))
    for (codes, scales), (jc, jsc) in zip(folded, jops):
        assert np.array_equal(codes.numpy(), np.asarray(jc))
        assert np.array_equal(scales.numpy(), np.asarray(jsc))
    codes, scales = folded[0]
    assert not codes[..., :2, :].any()
    assert (scales[..., :2, :] == tl.F32_TINY).all()
    # the single operand's codes are the dual's first, and the route's
    # composition is quantize_operands_plain's
    ((c1, s1),) = tqe.quant_fold_q8((torch.from_numpy(b1),), s_qt,
                                    torch.from_numpy(idx))
    assert torch.equal(c1, codes) and torch.equal(s1, scales)
    route = tcg.quantize_operands((torch.from_numpy(b1),), torch.from_numpy(qt),
                                  torch.from_numpy(idx))
    plain = tcg.quantize_operands_plain((torch.from_numpy(b1),),
                                        torch.from_numpy(qt),
                                        torch.from_numpy(idx))
    assert torch.equal(route[1], plain[1])
    assert all(torch.equal(a, b) for a, b in zip(route[0][0], plain[0][0]))
    assert ops.launch_counts(ops.LOWP)["quant_fold_q8"] == 0     # CPU: plain
    assert ops.launch_counts(ops.LOWP)["quant_qt_q8"] == 0


@jax.jit
def _jax_fold_jit(bs, s_qt, idx):
    """The fold and quantization of the b operands under jit, given the
    scales of Q^T."""
    s_sel = jnp.take(s_qt[:, 0], idx, axis=0)
    return [jl.quant_rows(b * s_sel[..., None, :]) for b in bs]


@pytest.mark.parametrize("name", list(CASES))
def test_quantizers_within_an_ulp_of_jax_jit(name):
    """Against JAX's quantizers under jit (as the Pallas colgather runs
    them) on the same inputs: Q^T's scales and each b's folded scales
    within one ulp, codes within one."""
    b1, b2, qt, idx = _operands(name)
    jq, js = jax.jit(jl.quant_rows)(jnp.asarray(qt))
    qt_q, s_qt = tqe.quant_qt_q8(torch.from_numpy(qt))
    assert np.abs(qt_q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    assert _ulps(s_qt.numpy(), np.asarray(js)) <= 1
    jops = _jax_fold_jit([jnp.asarray(b1), jnp.asarray(b2)],
                         jnp.asarray(s_qt.numpy()), jnp.asarray(idx))
    folded = tqe.quant_fold_q8((torch.from_numpy(b1), torch.from_numpy(b2)),
                               s_qt, torch.from_numpy(idx))
    for (codes, scales), (jc, jsc) in zip(folded, jops):
        assert np.abs(codes.numpy().astype(int)
                      - np.asarray(jc).astype(int)).max() <= 1
        assert _ulps(scales.numpy(), np.asarray(jsc)) <= 1


@pytest.mark.parametrize("name", list(CASES))
def test_int8_products_match_pallas(name):
    """The int8 dual and single on the route's operands (plain on the CPU)
    against JAX's ``colgather_matmul(..., compute_dtype="int8",
    interpret=True)``: within JIT_RTOL of max |out|, and bit-equal to the
    plain version of the whole function (``colgather_matmul_plain``); the
    single equal to the dual's first output."""
    b1, b2, qt, idx = _operands(name)
    jargs = (jnp.asarray(qt), jnp.asarray(idx))
    jo1, jo2 = jcg.colgather_matmul_dual(jnp.asarray(b1), jnp.asarray(b2),
                                         *jargs, interpret=True,
                                         compute_dtype="int8")
    jo = jcg.colgather_matmul(jnp.asarray(b1), *jargs, interpret=True,
                              compute_dtype="int8")
    tb1, tb2, tqt, tidx = map(torch.from_numpy, (b1, b2, qt, idx))
    ((q1, s1), (q2, s2)), qt_q = tcg.quantize_operands((tb1, tb2), tqt, tidx)
    o1, o2 = tcg.colgather_matmul_dual_q8(q1, s1, q2, s2, qt_q, tidx)
    single = tcg.colgather_matmul_q8(q1, s1, qt_q, tidx)
    assert torch.equal(single, o1)
    for got, want in ((o1, jo1), (o2, jo2), (single, jo)):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(got.numpy() - want).max()
        assert err <= JIT_RTOL * np.abs(want).max(), err
    p1, p2 = tcg.colgather_matmul_dual_plain(tb1, tb2, tqt, tidx,
                                             compute_dtype="int8")
    assert torch.equal(o1, p1) and torch.equal(o2, p2)
    assert torch.equal(single, tcg.colgather_matmul(tb1, tqt, tidx,
                                                    compute_dtype="int8"))


def _q8_args(batch=(2,), m=5, r=4, n=8):
    bq = torch.zeros((*batch, m, r), dtype=torch.int8)
    sb = torch.ones((*batch, m, 1))
    qt_q = torch.zeros((n, n), dtype=torch.int8)
    idx = torch.zeros((*batch, r), dtype=torch.int32)
    return bq, sb, qt_q, idx


def _fold_args():
    b = torch.zeros((2, 5, 4))
    return b, torch.ones((8, 1)), torch.zeros((2, 4), dtype=torch.int32)


REFUSALS = {
    # quant_fold_q8 (on the CPU too: it checks before it picks a device)
    "fold: int64 indices": (TypeError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0],), _fold_args()[1], _fold_args()[2].long())),
    "fold: fp64 b": (TypeError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0].double(),), *_fold_args()[1:])),
    "fold: scales not (n, 1)": (ValueError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0],), torch.ones(8), _fold_args()[2])),
    "fold: idx not (..., r)": (ValueError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0],), _fold_args()[1], _fold_args()[2][:, :3])),
    "fold: operands differ": (ValueError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0], _fold_args()[0][:, :4]), *_fold_args()[1:])),
    "fold: three operands": (ValueError, lambda: tqe.quant_fold_q8(
        (_fold_args()[0],) * 3, *_fold_args()[1:])),
    # the int8 products
    "single: fp32 codes": (TypeError, lambda: tcg.colgather_matmul_q8(
        _q8_args()[0].float(), *_q8_args()[1:])),
    "single: int64 indices": (TypeError, lambda: tcg.colgather_matmul_q8(
        *_q8_args()[:3], _q8_args()[3].long())),
    "single: scales not (..., m, 1)": (ValueError, lambda: tcg.colgather_matmul_q8(
        _q8_args()[0], torch.ones(2, 5), *_q8_args()[2:])),
    "single: Q^T not square": (ValueError, lambda: tcg.colgather_matmul_q8(
        *_q8_args()[:2], _q8_args()[2][:, :6], _q8_args()[3])),
    "dual: operands differ": (ValueError, lambda: tcg.colgather_matmul_dual_q8(
        _q8_args()[0], _q8_args()[1], _q8_args(m=6)[0], _q8_args(m=6)[1],
        *_q8_args()[2:])),
    "dual: fp32 Q^T codes": (TypeError, lambda: tcg.colgather_matmul_dual_q8(
        *_q8_args()[:2], *_q8_args()[:2], _q8_args()[2].float(),
        _q8_args()[3])),
    "single: depth past int32": (ValueError, lambda: tcg.colgather_matmul_q8(
        *_q8_args(batch=(), m=1, r=2**31 // 127**2 + 1, n=4))),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_int8_route_refuses(name):
    err, call = REFUSALS[name]
    with pytest.raises(err):
        call()
