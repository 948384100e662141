"""The four kernels of the DCT-AdamW step.

On the CPU each wrapper runs its plain PyTorch version (and launches
nothing), which is held against the JAX package's kernel entry point
(``repro.kernels.ops.*_op``, Pallas in interpret mode) on the same numpy
inputs. The CUDA kernels against their plain versions are in
``test_torch_cuda.py``, which needs no JAX.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dct import dct2_matrix as jax_dct2
from repro.kernels import ops as jops
from repro_torch.core.dct import dct2_matrix
from repro_torch.kernels import ops
from repro_torch.kernels import quant_ef as qe
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
dp = importlib.import_module("repro_torch.kernels.dct_project")

# (..., m, n) gradients as the optimizer hands them over (oriented): the
# shapes of tests/test_fused_step.py — 2d and transposed orient by a
# transpose, stacked carries a layer axis, odd is not a block multiple
SHAPES = {"2d": (40, 24), "stacked": (3, 40, 24), "odd": (33, 17),
          "transposed": (48, 16)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _idx(batch, n, r, seed):
    rng = np.random.default_rng(seed)
    out = np.stack([np.sort(rng.permutation(n)[:r])
                    for _ in range(int(np.prod(batch, dtype=int)))])
    return out.reshape(*batch, r).astype(np.int32)


@pytest.mark.parametrize("name", list(SHAPES))
def test_dct_project_plain_matches_jax(name):
    shape = SHAPES[name]
    n = shape[-1]
    g = _rand(shape, 1)
    q = dct2_matrix(n)
    before = ops.launch_counts()
    s, norms = dp.dct_project(torch.from_numpy(g), q)
    assert ops.launch_counts() == before        # CPU: plain version
    js, jn = jops.dct_project_op(jnp.asarray(g), jax_dct2(n))
    # rtol 1e-5: fp32 products summed in different orders (Pallas blocks
    # vs one matmul); atol for the entries that cancel to ~0
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), rtol=1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
def test_colgather_matmul_dual_plain_matches_jax(name):
    *batch, m, n = SHAPES[name]
    r = min(8, n)
    b1, b2 = _rand((*batch, m, r), 2), _rand((*batch, m, r), 3)
    idx = _idx(batch, n, r, 4)
    qt = dct2_matrix(n).T.contiguous()
    o1, o2 = cg.colgather_matmul_dual(torch.from_numpy(b1), torch.from_numpy(b2),
                                      qt, torch.from_numpy(idx))
    j1, j2 = jops.colgather_matmul_dual_op(jnp.asarray(b1), jnp.asarray(b2),
                                           jnp.asarray(qt.numpy()),
                                           jnp.asarray(idx))
    # rtol 1e-5: r-term fp32 sums in different orders
    np.testing.assert_allclose(o1.numpy(), np.asarray(j1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o2.numpy(), np.asarray(j2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(SHAPES))
def test_quant_ef_plain_matches_jax(name):
    shape = SHAPES[name]
    x = _rand(shape, 5, scale=3.0)
    x[..., 0, :] = 0.0            # all-zero row
    x[..., 1, :] = 1e-40          # subnormal row
    q, scale = qe.quantize_ef(torch.from_numpy(x))
    jq, jscale = jops.quantize_ef_op(jnp.asarray(x))
    # the scale is the IEEE quotient max|row| / 127, clamped to F32_TINY,
    # exactly; the Pallas op in interpret mode on the CPU is within one ulp
    # of it (XLA divides by the constant as a multiply by its reciprocal)
    ieee = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127),
                      np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(scale.numpy(), ieee)
    np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(jscale), 1)
    # |dq| <= 1: round half to even of x / scale in both; a one-ulp scale
    # difference can flip one unit at most
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    g = _rand(shape, 6)
    out = qe.dequant_add_ef(torch.from_numpy(g), q, scale)
    jout = jops.dequant_add_ef_op(jnp.asarray(g), jnp.asarray(q.numpy()),
                                  jnp.asarray(scale.numpy()))
    # one fp32 multiply and one add per element in both: equal, or an ulp
    # apart where a backend contracts them into an FMA
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        dp.dct_project(torch.zeros(4, 5), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        cg.colgather_matmul_dual(torch.zeros(3, 2), torch.zeros(3, 2),
                                 torch.zeros(4, 4),
                                 torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="compute_dtype"):
        dp.dct_project(torch.zeros(4, 4), torch.zeros(4, 4),
                       compute_dtype="fp16")


def test_launch_counters_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_every_entry_point_called_has_a_signature():
    """Each ``repro_*`` C entry point a wrapper calls has its argument
    types in ``cuda_lib.SIGNATURES`` (without them ctypes cannot pass a
    float and cuts a pointer to 32 bits)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import cuda_lib
    called = set()
    for path in Path(cuda_lib.__file__).parent.glob("*.py"):
        called |= set(re.findall(r"\b(repro_\w+)\(", path.read_text()))
    called = {c for c in called if not c.startswith("repro_error")}
    assert called and called <= set(cuda_lib.SIGNATURES), \
        called - set(cuda_lib.SIGNATURES)


def _op_cases():
    """``*_op`` name -> (the port's wrapper, arguments) on CPU tensors."""
    from repro_torch.kernels import flash_attention as fa_fn
    from repro_torch.kernels import flash_decode as fd_fn
    from repro_torch.kernels.newton_schulz import (newton_schulz_kernel,
                                                   ns_iteration)

    t = torch.from_numpy
    g = t(_rand((3, 40, 24), 11))
    q = dct2_matrix(24)
    qt = q.T.contiguous()
    idx = t(_idx((3,), 24, 6, 12))
    b1, b2 = t(_rand((3, 40, 6), 13)), t(_rand((3, 40, 6), 14))
    codes, scale = qe.quantize_ef(t(_rand((3, 40, 24), 15, 0.1)))
    table = t(np.array([[2, 0, 1], [3, 1, 0]], np.int32))
    lengths = t(np.array([10, 5], np.int32))
    return {
        "dct_project_op": (dp.dct_project, (g, q)),
        "colgather_matmul_op": (cg.colgather_matmul, (b1, qt, idx)),
        "colgather_matmul_dual_op": (cg.colgather_matmul_dual,
                                     (b1, b2, qt, idx)),
        "newton_schulz_op": (newton_schulz_kernel, (t(_rand((3, 8, 20), 16)),)),
        "ns_iteration_op": (ns_iteration, (t(_rand((3, 8, 20), 17, 0.2)),)),
        "flash_attention_op": (fa_fn, (t(_rand((2, 9, 4, 16), 18)),
                                       t(_rand((2, 9, 2, 16), 19)),
                                       t(_rand((2, 9, 2, 16), 20)))),
        "flash_decode_op": (fd_fn, (t(_rand((2, 4, 16), 21)),
                                    t(_rand((4, 4, 2, 16), 22)),
                                    t(_rand((4, 4, 2, 16), 23)), table,
                                    lengths)),
        "quantize_ef_op": (qe.quantize_ef, (g,)),
        "dequant_add_ef_op": (qe.dequant_add_ef, (g, codes, scale)),
    }


OP_NAMES = ["dct_project_op", "colgather_matmul_op", "colgather_matmul_dual_op",
            "newton_schulz_op", "ns_iteration_op", "flash_attention_op",
            "flash_decode_op", "quantize_ef_op", "dequant_add_ef_op"]


@pytest.mark.parametrize("name", OP_NAMES)
def test_op_alias_equals_its_wrapper_on_cpu(name):
    """The JAX package's dispatcher names, with its argument order: on CPU
    tensors each gives its wrapper's output bit for bit (the plain
    version) and launches nothing."""
    wrapper, args = _op_cases()[name]
    ops.reset_launch_counts()
    got, want = getattr(ops, name)(*args), wrapper(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert not any(ops.launch_counts().values())
    # the same names as the JAX package's ops module
    assert hasattr(jops, name)


def test_newton_schulz_pallas_is_newton_schulz_kernel():
    from repro_torch.kernels import newton_schulz_pallas
    from repro_torch.kernels.newton_schulz import newton_schulz_kernel
    assert newton_schulz_pallas is newton_schulz_kernel
