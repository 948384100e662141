"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (with the reason) where there is no CUDA
device. The file imports no JAX, so it runs on a machine with a card and
PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dct import dct2_matrix
from repro_torch.kernels import colgather_matmul as cg
from repro_torch.kernels import dct_project as dp
from repro_torch.kernels import ops
from repro_torch.kernels import quant_ef as qe

# (..., m, n) oriented gradients: 2d, a layer-stacked leaf, odd sizes that
# are no tile multiple, and a row count past one 128-row tile
SHAPES = {"2d": (40, 24), "stacked": (3, 40, 24), "odd": (33, 17),
          "transposed": (48, 16), "tiles": (2, 300, 136)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _idx(batch, n, r, seed):
    rng = np.random.default_rng(seed)
    out = np.stack([np.sort(rng.permutation(n)[:r])
                    for _ in range(int(np.prod(batch, dtype=int)))])
    return out.reshape(*batch, r).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_kernels_match_plain(cuda, name):
    shape = SHAPES[name]
    *batch, m, n = shape
    g = torch.from_numpy(_rand(shape, 7)).to(cuda)
    q = dct2_matrix(n, device=cuda)
    before = ops.launch_counts()
    s, norms = dp.dct_project(g, q)
    s_p, norms_p = dp.dct_project_plain(g, q)
    # fp32 sums over n terms in another order than cuBLAS
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)
    r = min(8, n)
    idx = torch.from_numpy(_idx(batch, n, r, 8)).to(cuda)
    b1 = torch.from_numpy(_rand((*batch, m, r), 9)).to(cuda)
    b2 = torch.from_numpy(_rand((*batch, m, r), 10)).to(cuda)
    qt = q.T.contiguous()
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    x = g.clone()
    x[..., 0, :] = 0.0
    x[..., 1, :] = 1e-40
    qk, sk = qe.quantize_ef(x)
    qp, sp = qe.quantize_ef_plain(x)
    # the same IEEE division and round-half-to-even in both
    assert torch.equal(sk, sp)
    assert (qk.int() - qp.int()).abs().max().item() <= 1
    assert torch.equal(qe.dequant_add_ef(g, qk, sk),
                       qe.dequant_add_ef_plain(g, qk, sk))
    after = ops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.cuda
def test_cuda_wrappers_reject_views_and_dtypes(cuda):
    q = dct2_matrix(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dp.dct_project(torch.zeros(16, 20, device=cuda).T, q)
    with pytest.raises(TypeError):
        qe.quantize_ef(torch.zeros(4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        dp.dct_project(torch.zeros(4, 16, device=cuda), q.cpu())
