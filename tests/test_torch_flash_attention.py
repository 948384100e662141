"""The dense ``flash_attention`` kernel of the port.

On the CPU the wrapper runs its plain version, ``flash_attention_ref``,
held to the JAX package's Pallas ``flash_attention`` in interpret mode on
the six cases of ``tests/test_kernels.py`` at that test's tolerances (fp32
3e-5, bf16 2e-2), plus group 5, hd 96 and S = 777 (against JAX's
``ref.flash_attention_ref``: the Pallas kernel asserts S divides by its
blocks), and to JAX's ``blockwise_attention`` at 3e-5. The route of the
model's ``blockwise_attention`` is held by the launch counter: no launch
for CPU tensors.

The ``cuda``-marked tests hold the CUDA kernel to its plain version on the
card: the serving shapes, fp32, group 5, hd 96 and 17, S = 1 and 777, a
window of 1, relaunches bit-identical, and the route (a launch without
grad, none under grad or with ``q_offset``). JAX is imported inside the
CPU tests only, so on a machine without JAX

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention.py

runs the card's tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

# tests/test_kernels.py::test_flash_attention_matches_ref
KERNEL_CASES = [
    (2, 256, 4, 2, 64, True, None, "float32"),
    (1, 512, 8, 8, 128, True, None, "bfloat16"),
    (2, 256, 4, 1, 64, False, None, "float32"),
    (1, 512, 4, 2, 64, True, 128, "float32"),
    (1, 256, 2, 2, 32, True, 64, "bfloat16"),
    (3, 128, 6, 3, 64, True, None, "float32"),
]
# shapes the Pallas kernel cannot take: group 5, hd 96, a ragged S
REF_CASES = [
    (1, 64, 10, 2, 32, True, None, "float32"),
    (2, 48, 4, 2, 96, True, 16, "float32"),
    (1, 777, 4, 2, 32, True, 100, "float32"),
    (1, 777, 4, 4, 16, False, None, "bfloat16"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(b, s, hq, hkv, hd, dtype, seed=0):
    """q, k, v as numpy fp32, already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        x = torch.from_numpy(rng.standard_normal((b, s, h, hd))
                             .astype(np.float32))
        out.append(x.to(getattr(torch, dtype)).float().numpy())
    return out


def _jax_arrays(arrs, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _port(arrs, dtype, **kw):
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    out = fa.flash_attention(*ts, **kw)
    assert out.dtype == ts[0].dtype and out.shape == ts[0].shape
    return out.float().numpy()


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dtype", KERNEL_CASES)
def test_plain_matches_pallas_interpret(b, s, hq, hkv, hd, causal, window,
                                        dtype):
    from repro.kernels.flash_attention import flash_attention
    arrs = _inputs(b, s, hq, hkv, hd, dtype)
    want = flash_attention(*_jax_arrays(arrs, dtype), causal=causal,
                           window=window, block_q=128, block_k=128,
                           interpret=True)
    got = _port(arrs, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dtype", REF_CASES)
def test_plain_matches_jax_ref(b, s, hq, hkv, hd, causal, window, dtype):
    from repro.kernels.ref import flash_attention_ref
    arrs = _inputs(b, s, hq, hkv, hd, dtype, seed=1)
    want = flash_attention_ref(*_jax_arrays(arrs, dtype), causal=causal,
                               window=window)
    got = _port(arrs, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])


def test_plain_matches_jax_blockwise():
    """tests/test_kernels.py::test_flash_attention_matches_blockwise_model_path
    on the port's plain version."""
    from repro.models.layers import blockwise_attention
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((2, 256, h, 64)).astype(np.float32)
            for h in (4, 2, 2)]
    want = blockwise_attention(*_jax_arrays(arrs, "float32"), causal=True,
                               q_chunk=64, kv_chunk=64)
    got = _port(arrs, "float32", causal=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5)


def test_model_attention_on_cpu_never_launches():
    """CPU tensors run the chunked loop, with or without grad."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 16,
                                                      "float32"))
    ops.reset_launch_counts(ops.ATTENTION)
    with torch.inference_mode():
        a = TL.blockwise_attention(q, k, v, causal=True, q_chunk=8,
                                   kv_chunk=8)
    b = TL.blockwise_attention(q.requires_grad_(), k, v, causal=True,
                               q_chunk=8, kv_chunk=8)
    assert ops.launch_counts(ops.ATTENTION) == {"flash_attention": 0}
    torch.testing.assert_close(a, b.detach())
    torch.testing.assert_close(a, fa.flash_attention(q.detach(), k, v),
                               atol=3e-5, rtol=0)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, s, hq, hkv, hd, causal, window, dtype): the serving shapes at a
# shorter S, then the edge cases of chip_smoke.py's phase 12
CUDA_CASES = {
    "llama": (2, 512, 16, 16, 64, True, None, "bfloat16"),
    "gemma-local": (1, 1024, 32, 16, 128, True, 256, "bfloat16"),
    "gemma-global": (1, 1024, 32, 16, 128, True, None, "bfloat16"),
    "fp32": (2, 300, 8, 2, 64, True, None, "float32"),
    "group5": (1, 200, 10, 2, 64, True, 50, "float32"),
    "hd96": (2, 130, 4, 2, 96, True, None, "float32"),
    "hd17": (1, 70, 3, 1, 17, False, None, "float32"),
    "hd256": (1, 100, 2, 1, 256, True, None, "bfloat16"),
    "s1": (3, 1, 4, 2, 64, True, None, "float32"),
    "s777": (1, 777, 4, 2, 64, True, 100, "bfloat16"),
    "window1": (1, 129, 4, 4, 32, True, 1, "float32"),
    "noncausal-window": (1, 200, 4, 2, 32, False, 70, "float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_kernel_matches_plain(cuda, name):
    b, s, hq, hkv, hd, causal, window, dtype = CUDA_CASES[name]
    ts = [torch.from_numpy(a).to(cuda, getattr(torch, dtype))
          for a in _inputs(b, s, hq, hkv, hd, dtype, seed=2)]
    before = fa.flash_attention.launches
    got = fa.flash_attention(*ts, causal=causal, window=window)
    again = fa.flash_attention(*ts, causal=causal, window=window)
    want = fa.flash_attention_ref(*ts, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert got.dtype == ts[0].dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views(cuda):
    """q, k, v as head-dim-contiguous views of one packed projection."""
    qkv = torch.randn(2, 96, 4 + 2 + 2, 32, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k,
                           v)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q, k.bfloat16(), v)


@pytest.mark.cuda
def test_cuda_route_launches_only_without_grad(cuda):
    """The model's attention launches the kernel for a no-grad call with
    q_offset 0 and Sq == Skv, and runs the chunked loop otherwise."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _inputs(1, 64, 4, 2, 32, "float32", seed=3))
    ops.reset_launch_counts(ops.ATTENTION)
    with torch.inference_mode():
        a = TL.blockwise_attention(q, k, v, causal=True, window=16,
                                   q_chunk=16, kv_chunk=16)
    assert fa.flash_attention.launches == 1
    b = TL.blockwise_attention(q.clone().requires_grad_(), k, v, causal=True,
                               window=16, q_chunk=16, kv_chunk=16)
    with torch.inference_mode():
        TL.blockwise_attention(q[:, 32:], k, v, causal=True, q_offset=32,
                               q_chunk=16, kv_chunk=16)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1
    torch.testing.assert_close(a, b.detach(), atol=3e-5, rtol=0)
