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
from repro_torch.kernels import flash_decode as fd
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
    before = ops.launch_counts(ops.TRAINING)
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
    after = ops.launch_counts(ops.TRAINING)
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


def _fd_inputs(cuda, *, b, hq, hkv, hd, bs, maxb, lengths, dtype, seed=0):
    """Distinct pool blocks per slot, unused table entries 0."""
    rng = np.random.default_rng(seed)
    need = [-(-n // bs) for n in lengths]
    nb = sum(need) + 2
    free = list(rng.permutation(nb))
    table = np.zeros((b, maxb), np.int32)
    for i, n in enumerate(need):
        table[i, :n] = [free.pop() for _ in range(n)]
    q = torch.from_numpy(_rand((b, hq, hd), seed)).to(cuda)
    k = torch.from_numpy(_rand((nb, bs, hkv, hd), seed + 1)).to(cuda, dtype)
    v = torch.from_numpy(_rand((nb, bs, hkv, hd), seed + 2)).to(cuda, dtype)
    return (q, k, v, torch.from_numpy(table).to(cuda),
            torch.tensor(lengths, dtype=torch.int32, device=cuda))


# (Hq, Hkv, hd, bs, MAXB, lengths, pool dtype): MHA at llama-350m's head
# shape, GQA, 8q/1kv, odd head dims, a length-0 row, blocks of 1 and 40
FD_CASES = {
    "mha": (16, 16, 64, 16, 8, [1, 50, 128, 0], torch.bfloat16),
    "gqa": (32, 8, 128, 16, 4, [64, 17, 33], torch.bfloat16),
    "8q1kv": (8, 1, 64, 8, 6, [48, 1, 20], torch.float32),
    "hd17": (4, 2, 17, 8, 3, [11, 24], torch.float32),
    "hd31": (4, 2, 31, 4, 5, [19, 6], torch.float32),
    "bs1": (4, 4, 16, 1, 40, [40, 3], torch.float32),
    "bs40": (4, 2, 16, 40, 3, [100, 41], torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FD_CASES))
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 5])
def test_cuda_flash_decode_matches_plain(cuda, name, splits, window):
    hq, hkv, hd, bs, maxb, lengths, dtype = FD_CASES[name]
    q, *rest = _fd_inputs(cuda, b=len(lengths), hq=hq, hkv=hkv, hd=hd,
                          bs=bs, maxb=maxb, lengths=lengths, dtype=dtype)
    before = ops.launch_counts(ops.SERVING)["flash_decode"]
    for q_dt in (torch.float32, torch.bfloat16):
        qq = q.to(q_dt)
        got = fd.flash_decode(qq, *rest, window=window, num_splits=splits)
        want = fd.flash_decode_plain(qq, *rest, window=window,
                                     num_splits=splits)
        assert got.dtype == q_dt
        if q_dt == torch.float32:
            # sums over the same keys in another order
            torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
        else:
            # fp32 inside; the bf16 roundings may land on neighbours
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-6)
        zero = [i for i, n in enumerate(lengths) if n == 0]
        assert not got[zero].any()
    assert ops.launch_counts(ops.SERVING)["flash_decode"] == before + 2


@pytest.mark.cuda
def test_cuda_flash_decode_never_reads_past_lengths(cuda):
    """NaN in every pool position past each slot's length, and unused table
    entries pointing at a poisoned block, change no bit of the output."""
    lengths = [37, 0, 16]
    q, k, v, table, ln = _fd_inputs(cuda, b=3, hq=8, hkv=2, hd=64, bs=16,
                                    maxb=4, lengths=lengths,
                                    dtype=torch.bfloat16)
    clean = fd.flash_decode(q, k, v, table, ln, num_splits=2)
    nblk = [-(-n // 16) for n in lengths]
    used = {b for i, n in enumerate(nblk) for b in table[i, :n].tolist()}
    poison = sorted(set(range(k.shape[0])) - used)
    k[poison] = float("nan")
    v[poison] = float("nan")
    for i, n in enumerate(lengths):
        if n % 16:
            k[table[i, nblk[i] - 1], n % 16:] = float("nan")
            v[table[i, nblk[i] - 1], n % 16:] = float("nan")
        table[i, nblk[i]:] = poison[0]
    assert torch.equal(fd.flash_decode(q, k, v, table, ln, num_splits=2),
                       clean)
    assert not clean[1].any()


@pytest.mark.cuda
def test_cuda_flash_decode_rejects_views_and_dtypes(cuda):
    q, k, v, table, ln = _fd_inputs(cuda, b=2, hq=4, hkv=2, hd=16, bs=4,
                                    maxb=2, lengths=[3, 5],
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                        v, table, ln)
    with pytest.raises(TypeError):
        fd.flash_decode(q.double(), k, v, table, ln)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v, table.long(), ln)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, table.cpu(), ln)
