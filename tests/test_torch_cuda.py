"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (with the reason) where there is no CUDA
device. The file imports no JAX, so it runs on a machine with a card and
PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.dct import dct2_matrix
from repro_torch.core.newton_schulz import NS_COEFFS, _ns_step, newton_schulz
from repro_torch.kernels import newton_schulz as ns
from repro_torch.kernels import ops
from repro_torch.kernels import quant_ef as qe
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
cg = importlib.import_module("repro_torch.kernels.colgather_matmul")
dp = importlib.import_module("repro_torch.kernels.dct_project")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fd = importlib.import_module("repro_torch.kernels.flash_decode")

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
def test_cuda_synthetic_batches_repeat(cuda):
    """One (seed, step) gives the same batch on every call on the card (the
    Zipf CDF is summed on the CPU: a CUDA cumsum of one long vector may add
    in another order from call to call)."""
    from repro_torch.data.synthetic import SyntheticLM
    ds = SyntheticLM(vocab_size=32000, seq_len=512, global_batch=8)
    first = ds.batch(0, cuda)
    for _ in range(200):
        again = ds.batch(0, cuda)
        assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.cuda
def test_cuda_wrappers_reject_views_and_dtypes(cuda):
    q = dct2_matrix(16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dp.dct_project(torch.zeros(16, 20, device=cuda).T, q)
    with pytest.raises(TypeError):
        qe.quantize_ef(torch.zeros(4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        dp.dct_project(torch.zeros(4, 16, device=cuda), q.cpu())


# wide NS factors (..., r, m): ragged r and m, Trion's llama-350m factor, a
# stacked one, a stacked ragged one past one Gram tile, and r = 1
NS_SHAPES = {"r17m100": (17, 100), "trion": (128, 2816),
             "stacked": (3, 128, 300), "stacked_ragged": (2, 45, 333),
             "r1": (1, 64)}
# gram (m-term sums), apply and one iteration (r-term sums) in other orders
# than cuBLAS, relative to max |out|
NS_RTOL = 1e-5


def _ns_input(shape, cuda, seed=0):
    """A wide factor scaled like the first iteration's input."""
    x = torch.from_numpy(_rand(shape, seed)).to(cuda)
    return x / (torch.linalg.norm(x, dim=(-2, -1), keepdim=True) + 1e-7)


def _assert_rel(got, want, rtol):
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NS_SHAPES))
def test_cuda_ns_kernels_match_plain(cuda, name):
    a, b, c = NS_COEFFS
    x = _ns_input(NS_SHAPES[name], cuda)
    before = ops.launch_counts(ops.MOMENTUM)
    g = ns.ns_gram(x)
    # the split's partials are summed in a fixed order: the same bits on
    # every launch; each block off the diagonal written to both places, and
    # A[p][q], A[q][p] inside a diagonal block from the same FMAs
    assert torch.equal(g, ns.ns_gram(x))
    assert torch.equal(g, g.mT)
    _assert_rel(g, ns.ns_gram_plain(x), NS_RTOL)
    p = b * g + c * torch.matmul(g, g)
    y = ns.ns_apply(x, p, a=a)
    assert torch.equal(y, ns.ns_apply(x, p, a=a))
    _assert_rel(y, ns.ns_apply_plain(x, p, a), NS_RTOL)
    buf = torch.empty_like(x)
    assert ns.ns_apply(x, p, a=a, out=buf) is buf and torch.equal(buf, y)
    _assert_rel(ns.ns_iteration(x), _ns_step(x), NS_RTOL)
    after = ops.launch_counts(ops.MOMENTUM)
    assert after["ns_gram"] == before["ns_gram"] + 3
    assert after["ns_apply"] == before["ns_apply"] + 4


# ns_gram at the ranks fused_step routes (one to four 32-row blocks, and
# r > 128: several 128-row macro tiles) on m of one column, below one
# range of the split, off a multiple of 4, and at 16 ranges
GRAM_RANKS = (8, 17, 45, 128, 300, 512)
GRAM_COLS = (1, 37, 333, 1030)


def _gram_input(cuda, batch, r, m, seed=0):
    x = _rand((batch, r, m), seed + r + m)
    x /= np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    return torch.from_numpy(x).to(cuda)


def _assert_gram(g, x):
    """Relaunch bit-identical, exactly symmetric, within NS_RTOL of max
    |A| of the plain version."""
    assert torch.equal(g, ns.ns_gram(x))
    assert torch.equal(g, g.mT)
    _assert_rel(g, ns.ns_gram_plain(x), NS_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 24])
@pytest.mark.parametrize("m", GRAM_COLS)
@pytest.mark.parametrize("r", GRAM_RANKS)
def test_cuda_ns_gram_ranks(cuda, r, m, batch):
    x = _gram_input(cuda, batch, r, m)
    before = ns.ns_gram.launches
    g = ns.ns_gram(x)
    assert g.shape == (batch, r, r) and ns.ns_gram.launches == before + 1
    _assert_gram(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [45, 128, 300])
def test_cuda_ns_gram_any_split(cuda, r):
    """Through the C entry point, every split of m (1-64 ranges; 16-byte
    and, with X 4 bytes off 16, 4-byte copies; A 4 bytes off 16: 4-byte
    stores) is within NS_RTOL of the plain version, exactly symmetric and
    the same bits on a relaunch; a split the kernels cannot take is refused
    before any launch."""
    from repro_torch.kernels import cuda_lib
    m = 1000
    x0 = _rand((3, r, m), 11)
    x0 /= np.linalg.norm(x0, axis=(-2, -1), keepdims=True)
    want = ns.ns_gram_plain(torch.from_numpy(x0).to(cuda))
    lib = cuda_lib.library()
    for offset in (0, 1):
        x = _at_offset(cuda, x0, offset)
        st = cuda_lib.stream(x)
        for splits in (1, 3, 8, 16, 22, ns.GRAM_MAX_SPLITS):
            width = -(-m // splits // ns.GRAM_SLICE) * ns.GRAM_SLICE
            ws = torch.empty(ns.ns_gram_workspace_floats(3, r, splits),
                             device=cuda)
            outs = []
            for _ in range(2):
                out = _at_offset(cuda, np.zeros((3, r, r), np.float32), offset)
                rc = lib.repro_ns_gram(x.data_ptr(), out.data_ptr(),
                                       ws.data_ptr(), 3, r, m, splits, width,
                                       st)
                assert rc == 0, (splits, rc)
                outs.append(out)
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1]), splits
            assert torch.equal(outs[0], outs[0].mT), splits
            _assert_rel(outs[0], want, NS_RTOL)
        out = torch.full((3, r, r), 7.0, device=cuda)
        ws = torch.empty(ns.ns_gram_workspace_floats(3, r, 1), device=cuda)
        for splits, width in ((ns.GRAM_MAX_SPLITS + 1, 64), (0, 64), (16, 8),
                              (2, 16), (1, -16)):
            rc = lib.repro_ns_gram(x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                   3, r, m, splits, width, st)
            assert rc != 0, (splits, width)
        torch.cuda.synchronize()
        assert bool((out == 7.0).all())


@pytest.mark.cuda
def test_cuda_ns_gram_two_streams(cuda):
    """Two calls in flight on two streams give the bits of one call alone."""
    x1 = _gram_input(cuda, 24, 128, 2816, seed=1)
    x2 = _gram_input(cuda, 24, 128, 1024, seed=2)
    want1, want2 = ns.ns_gram(x1), ns.ns_gram(x2)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    got = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            g1 = ns.ns_gram(x1)
        with torch.cuda.stream(s2):
            g2 = ns.ns_gram(x2)
        got.append((g1, g2))
    torch.cuda.synchronize()
    for g1, g2 in got:
        assert torch.equal(g1, want1) and torch.equal(g2, want2)


@pytest.mark.cuda
def test_cuda_ns_gram_graph_capture(cuda):
    """A call captured in a CUDA graph and replayed equals the eager one,
    and each replay writes the graph's output anew."""
    x = _gram_input(cuda, 24, 128, 1024, seed=3)
    want = ns.ns_gram(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ns.ns_gram(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ns.ns_gram(x)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2816, 128), (3, 100, 17), (16, 64),
                                   (2, 333, 45)])
def test_cuda_newton_schulz_kernel_matches_core(cuda, shape):
    """Five iterations: the quintic's slope at 0 (3.4445) amplifies relative
    differences up to ~500x, so 1e-4 of max |out| here."""
    x = torch.from_numpy(_rand(shape, 3)).to(cuda)
    got = ns.newton_schulz_kernel(x, steps=5)
    assert got.shape == x.shape and torch.equal(
        got, ns.newton_schulz_kernel(x, steps=5))
    _assert_rel(got, newton_schulz(x, steps=5), 1e-4)


# ns_apply at the ranks fused_step routes, on ragged wide factors (..., r,
# m): one row block (r <= 128) and several (300, 512)
APPLY_CASES = {"r8": (8, 100), "r17": (17, 333), "r45": (2, 45, 1000),
               "r128": (3, 128, 1030), "r300": (300, 333),
               "r512": (2, 512, 700)}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", list(APPLY_CASES))
def test_cuda_ns_apply_ranks(cuda, name, offset):
    """Y within NS_RTOL of max |Y| of the plain version, a relaunch
    bit-identical, each launch counted; ``offset`` 1 puts X 4 bytes off 16
    (the 4-byte copies), which gives the same bits as the aligned X."""
    a, b, c = NS_COEFFS
    shape = APPLY_CASES[name]
    x0 = _rand(shape, 5)
    x0 /= np.linalg.norm(x0, axis=(-2, -1), keepdims=True)
    x = _at_offset(cuda, x0, offset)
    g = ns.ns_gram_plain(x)
    p = b * g + c * torch.matmul(g, g)
    before = ns.ns_apply.launches
    y = ns.ns_apply(x, p, a=a)
    again = ns.ns_apply(x, p, a=a)
    aligned = ns.ns_apply(torch.from_numpy(x0).to(cuda), p, a=a)
    want = ns.ns_apply_plain(x, p, a)
    torch.cuda.synchronize()
    assert ns.ns_apply.launches == before + 3
    assert torch.equal(y, again) and torch.equal(y, aligned)
    _assert_rel(y, want, NS_RTOL)


@pytest.mark.cuda
def test_cuda_ns_apply_envelope(cuda):
    """The largest r the kernel takes launches; one more is refused before
    any launch (a block's shared memory cannot hold X's stripe)."""
    a = NS_COEFFS[0]
    r = ns.APPLY_MAX_RANK
    x = _ns_input((r, 130), cuda)
    p = torch.from_numpy(_rand((r, r), 6, 1e-2)).to(cuda)
    before = ns.ns_apply.launches
    _assert_rel(ns.ns_apply(x, p, a=a), ns.ns_apply_plain(x, p, a), NS_RTOL)
    assert ns.ns_apply.launches == before + 1
    x = _ns_input((r + 1, 130), cuda)
    with pytest.raises(ValueError, match="APPLY_MAX_RANK"):
        ns.ns_apply(x, torch.zeros(r + 1, r + 1, device=cuda), a=a)
    assert ns.ns_apply.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_colgather_matmul_matches_plain(cuda, name):
    *batch, m, n = SHAPES[name]
    r = min(8, n)
    idx = torch.from_numpy(_idx(batch, n, r, 8)).to(cuda)
    b = torch.from_numpy(_rand((*batch, m, r), 9)).to(cuda)
    qt = dct2_matrix(n, device=cuda).T.contiguous()
    before = ops.launch_counts(ops.MOMENTUM)["colgather_matmul"]
    got = cg.colgather_matmul(b, qt, idx)
    torch.testing.assert_close(got, cg.colgather_matmul_plain(b, qt, idx),
                               rtol=1e-5, atol=1e-5)
    # one template: the single operand sums in the dual kernel's order
    assert torch.equal(got, cg.colgather_matmul_dual(b, b, qt, idx)[0])
    assert ops.launch_counts(ops.MOMENTUM)["colgather_matmul"] == before + 1


@pytest.mark.cuda
def test_cuda_ns_wrappers_reject_views_and_dtypes(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ns.ns_gram(torch.zeros(2, 16, 8, device=cuda).mT)
    with pytest.raises(TypeError):
        ns.ns_gram(x.double())
    with pytest.raises(ValueError):
        ns.ns_apply(x, torch.zeros(2, 8, 8))
    with pytest.raises(TypeError):
        cg.colgather_matmul(torch.zeros(4, 2, device=cuda),
                            torch.zeros(4, 4, device=cuda),
                            torch.zeros(2, dtype=torch.int64, device=cuda))


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


# flash_decode against its plain version: fp32 within this share of max
# |out| (sums over up to 2048 keys in another order); bf16 within that plus
# one bf16 ulp of each element (the last rounding)
FD_RTOL_F32 = 2e-6


def _bf16_ulps_past(got, want, slack):
    """max over elements of (|got - want| - slack) in bf16 ulps of the larger
    magnitude: <= 1 when the two are within ``slack`` before their last
    rounding to bf16."""
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    d = torch.clamp_min((a - b).abs() - slack, 0.0)
    return torch.where(mag > 0, d / ulp, d).max().item()


def _fd_twice_against_plain(q, rest, window, splits):
    """The kernel twice (bit-identical) against its plain version."""
    got = fd.flash_decode(q, *rest, window=window, num_splits=splits)
    again = fd.flash_decode(q, *rest, window=window, num_splits=splits)
    want = fd.flash_decode_plain(q, *rest, window=window, num_splits=splits)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and torch.isfinite(got).all()
    assert torch.equal(got, again), "relaunch differs"
    top = want.float().abs().max().item()
    if q.dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= FD_RTOL_F32 * top, (err, top)
    else:
        assert _bf16_ulps_past(got, want, FD_RTOL_F32 * top) <= 1.0
    return got


# (bs, hd, Hq, Hkv, pool dtype): blocks of 8 / 16 / 32, head dims 17 (the
# scalar path, fp32 and bf16 pools), 64 and 128 (the 16-byte path in bf16),
# groups 1 / 2 / 5 / 8; every case has slots of length 0, 1, bs, bs + 1 and
# 2048
FD_SWEEP = {
    "bs8 hd64 g1 bf16": (8, 64, 4, 4, torch.bfloat16),
    "bs16 hd64 g1 bf16": (16, 64, 16, 16, torch.bfloat16),
    "bs32 hd64 g2 bf16": (32, 64, 8, 4, torch.bfloat16),
    "bs16 hd128 g2 bf16": (16, 128, 8, 4, torch.bfloat16),
    "bs16 hd128 g5 bf16": (16, 128, 10, 2, torch.bfloat16),
    "bs8 hd128 g8 bf16": (8, 128, 8, 1, torch.bfloat16),
    "bs16 hd17 g2 f32": (16, 17, 4, 2, torch.float32),
    "bs8 hd17 g5 bf16": (8, 17, 10, 2, torch.bfloat16),
    "bs32 hd64 g8 f32": (32, 64, 16, 2, torch.float32),
    "bs16 hd128 g1 f32": (16, 128, 2, 2, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 1, 100, 1024])
@pytest.mark.parametrize("name", list(FD_SWEEP))
def test_cuda_flash_decode_sweep(cuda, name, window):
    """Every split count from 1 to MAXB, fp32 and bf16 q, each launched
    twice: held to the plain version, bit-identical, length 0 exactly 0."""
    bs, hd, hq, hkv, dtype = FD_SWEEP[name]
    lengths = [0, 1, bs, bs + 1, 2048]
    maxb = 2048 // bs
    q, *rest = _fd_inputs(cuda, b=len(lengths), hq=hq, hkv=hkv, hd=hd, bs=bs,
                          maxb=maxb, lengths=lengths, dtype=dtype, seed=3)
    assert fd.vector_path(*rest[:2]) == (dtype == torch.bfloat16
                                         and hd % 8 == 0)
    before = fd.flash_decode.launches
    for splits in (1, 2, 3, maxb):
        for q_dt in (torch.float32, torch.bfloat16):
            got = _fd_twice_against_plain(q.to(q_dt), rest, window, splits)
            assert not got[0].any()
    assert fd.flash_decode.launches == before + 16


# (hd, pool dtype, Hq, Hkv, window): the 16-byte path, gemma3's local
# shape, the scalar path
FD_POISON = {"hd64 bf16": (64, torch.bfloat16, 8, 2, None),
             "hd128 bf16 window": (128, torch.bfloat16, 8, 4, 20),
             "hd17 f32": (17, torch.float32, 4, 2, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FD_POISON))
def test_cuda_flash_decode_poisoned_pool_and_bad_entry(cuda, name):
    """NaN in every pool position no slot reaches changes no bit; a table
    entry outside the pool that a valid token needs makes that slot's rows
    NaN (and only those), one past every length changes nothing."""
    hd, dtype, hq, hkv, window = FD_POISON[name]
    bs, lengths = 16, [37, 0, 16, 70]
    q, k, v, table, ln = _fd_inputs(cuda, b=4, hq=hq, hkv=hkv, hd=hd, bs=bs,
                                    maxb=6, lengths=lengths, dtype=dtype,
                                    seed=4)
    clean = fd.flash_decode(q, k, v, table, ln, window=window, num_splits=2)
    nblk = [-(-n // bs) for n in lengths]
    used = {b for i, n in enumerate(nblk) for b in table[i, :n].tolist()}
    poison = sorted(set(range(k.shape[0])) - used)
    k[poison] = float("nan")
    v[poison] = float("nan")
    for i, n in enumerate(lengths):
        if n % bs:
            k[table[i, nblk[i] - 1], n % bs:] = float("nan")
            v[table[i, nblk[i] - 1], n % bs:] = float("nan")
        table[i, nblk[i]:] = k.shape[0] + 5 if i % 2 else poison[0]
    dirty = fd.flash_decode(q, k, v, table, ln, window=window, num_splits=2)
    torch.cuda.synchronize()
    assert torch.equal(dirty, clean)
    assert not clean[1].any()
    table[3, 4] = -1                       # slot 3 needs column 4 (64..69)
    bad = fd.flash_decode(q, k, v, table, ln, window=window, num_splits=2)
    torch.cuda.synchronize()
    assert torch.isnan(bad[3]).all()
    assert torch.equal(bad[:3], clean[:3])


# fp32 flash_attention (the fp32 route): (b, s, hq, hkv, hd, causal, window,
# dtype); head dims 17 / 64 / 96 / 128, S 1 / 257 / 777, windows 1 / 128,
# group 5, causal and not, bf16 inputs upcast
FA_TOL_F32 = 3e-5
FA32_CASES = {
    "hd64 s257": (2, 257, 8, 8, 64, True, None, torch.float32),
    "hd64 s777 window128": (1, 777, 4, 2, 64, True, 128, torch.float32),
    "hd128 s777": (1, 777, 4, 2, 128, True, None, torch.float32),
    "hd128 s257 window1": (1, 257, 4, 4, 128, True, 1, torch.float32),
    "hd96 s257": (2, 257, 6, 3, 96, True, None, torch.float32),
    "hd17 s257": (1, 257, 4, 2, 17, True, None, torch.float32),
    "hd17 s1": (3, 1, 4, 2, 17, True, None, torch.float32),
    "hd64 s1": (3, 1, 4, 2, 64, True, None, torch.float32),
    "group5 window128": (1, 300, 10, 2, 64, True, 128, torch.float32),
    "noncausal hd64": (2, 130, 6, 3, 64, False, None, torch.float32),
    "noncausal window1": (1, 200, 4, 2, 128, False, 1, torch.float32),
    "hd256 s100": (1, 100, 2, 1, 256, True, None, torch.float32),
    "bf16 hd64 s257": (2, 257, 8, 4, 64, True, None, torch.bfloat16),
    "bf16 hd128 window128": (1, 777, 4, 2, 128, True, 128, torch.bfloat16),
    "bf16 hd17 noncausal": (1, 100, 5, 1, 17, False, None, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FA32_CASES))
def test_cuda_flash_attention_fp32_matches_plain(cuda, name):
    """The 3xTF32 kernel twice (bit-identical) against its plain version:
    fp32 within FA_TOL_F32; bf16 within that plus one bf16 ulp."""
    b, s, hq, hkv, hd, causal, window, dtype = FA32_CASES[name]
    q, k, v = (torch.from_numpy(_rand((b, s, h, hd), 20 + i)).to(cuda, dtype)
               for i, h in enumerate((hq, hkv, hkv)))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= FA_TOL_F32
    else:
        assert _bf16_ulps_past(got, want, FA_TOL_F32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 17])
def test_cuda_flash_attention_fp32_copy_paths_agree(cuda, hd):
    """Rows off 16 bytes take the 4-byte copies, aligned rows the 16-byte
    ones: the same arithmetic, so the same bits."""
    b, s, h = 2, 150, 4
    n = b * s * h * hd
    flat = torch.from_numpy(_rand(3 * n + 1, 30)).to(cuda)
    q, k, v = (flat[1 + i * n:1 + (i + 1) * n].view(b, s, h, hd)
               for i in range(3))
    aligned = [t.clone() for t in (q, k, v)]
    got = fa.flash_attention(q, k, v, causal=True, window=40)
    want = fa.flash_attention(*aligned, causal=True, window=40)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# bf16 operands: the kernel and the plain version multiply the same rounded
# values exactly and differ only by the order of the fp32 sums
LOWP_RTOL = 1e-6


def _assert_rel_max(got, want, rtol):
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 17, 40])
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_lowp_kernels_match_plain(cuda, name, r):
    """The bf16 and int8 projection kernels against their plain versions:
    int8 bit for bit (exact integer sums, the same epilogue order), the bf16
    dct_project at LOWP_RTOL of max |out|, the bf16 colgathers (tensor
    cores) at LOWP_TC_RTOL; each launch counted on its precision's name."""
    from repro_torch.kernels import lowp
    *batch, m, n = SHAPES[name]
    r = min(r, n)
    g = torch.from_numpy(_rand((*batch, m, n), 7)).to(cuda)
    g[..., 0, :] = 0.0                              # zero and subnormal rows
    g[..., 1, :] = 1e-40
    q = dct2_matrix(n, device=cuda)
    qt = q.T.contiguous()
    idx = torch.from_numpy(_idx(batch, n, r, 8)).to(cuda)
    b1 = torch.from_numpy(_rand((*batch, m, r), 9)).to(cuda)
    b2 = torch.from_numpy(_rand((*batch, m, r), 10)).to(cuda)
    ops.reset_launch_counts()

    s, norms = dp.dct_project(g, q, compute_dtype="bf16")
    s_p, norms_p = dp.dct_project_plain(g, q, compute_dtype="bf16")
    _assert_rel_max(s, s_p, LOWP_RTOL)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)
    gq, sg = lowp.quant_rows(g)
    qq, sq = lowp.quant_cols(q)
    s, norms = dp.dct_project(g, q, compute_dtype="int8")
    s_p, norms_p = dp.dct_project_q8_plain(gq, sg, qq, sq)
    assert torch.equal(s, s_p)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)

    # the bf16 colgathers run on the tensor cores: LOWP_TC_RTOL
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx,
                                             compute_dtype="bf16"),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                   compute_dtype="bf16")):
        _assert_rel_max(a, b, LOWP_TC_RTOL)
    _assert_rel_max(cg.colgather_matmul(b1, qt, idx, compute_dtype="bf16"),
                    cg.colgather_matmul_plain(b1, qt, idx,
                                              compute_dtype="bf16"),
                    LOWP_TC_RTOL)
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx,
                                             compute_dtype="int8"),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                   compute_dtype="int8")):
        assert torch.equal(a, b)
    assert torch.equal(cg.colgather_matmul(b1, qt, idx, compute_dtype="int8"),
                       cg.colgather_matmul_plain(b1, qt, idx,
                                                 compute_dtype="int8"))
    # the one int8 dct_project also launched each of its operand quantizers
    # (quant_rows_q8, quant_cols_q8t) once; each int8 colgather (a dual,
    # a single) its two (quant_qt_q8, quant_fold_q8) once
    assert ops.launch_counts(ops.LOWP) == {
        name: 2 if name in ("quant_qt_q8", "quant_fold_q8") else 1
        for name in ops.LOWP}
    assert not any(ops.launch_counts(ops.TRAINING).values())


@pytest.mark.cuda
def test_cuda_lowp_wrappers_reject_views_and_dtypes(cuda):
    q = dct2_matrix(16, device=cuda)
    gq = torch.zeros(4, 16, dtype=torch.int8, device=cuda)
    sg = torch.ones(4, 1, device=cuda)
    qq = torch.zeros(16, 16, dtype=torch.int8, device=cuda)
    sq = torch.ones(1, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dp.dct_project(torch.zeros(16, 20, device=cuda).T, q,
                       compute_dtype="bf16")
    with pytest.raises(TypeError):
        dp.dct_project_q8(gq.float(), sg, qq, sq)
    with pytest.raises(ValueError, match="contiguous"):
        dp.dct_project_q8(gq, sg, qq.T, sq)
    with pytest.raises(ValueError):
        dp.dct_project_q8(gq, sg, qq, sq.cpu())
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cg.colgather_matmul_q8(torch.zeros(4, 2, device=cuda),
                               torch.ones(4, 1, device=cuda), qq, idx)
    with pytest.raises(TypeError):
        cg.colgather_matmul(torch.zeros(4, 2, device=cuda), q.T.contiguous(),
                            idx.long(), compute_dtype="int8")


@pytest.mark.cuda
def test_cuda_bf16_rounding_specials(cuda):
    """The kernels round to bf16 on the bits: a NaN stays NaN, a value past
    bf16's largest rounds to inf and a tie to even, as ``.to(bfloat16)``."""
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3.4e38,
                      1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -0.0, 1e-45],
                     device=cuda)
    # one column and Q = [[1]]: S is the rounded G itself
    s, _ = dp.dct_project(x[:, None], torch.ones(1, 1, device=cuda),
                          compute_dtype="bf16")
    want = x.to(torch.bfloat16).float()
    assert torch.equal(torch.isnan(s[:, 0]), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(s[:, 0][fin], want[fin])


# bf16 dct_project on the tensor cores: (..., m, n) with ragged m and n;
# n % 4 == 0 takes the 16-byte copies, the others (and an operand off 16
# bytes) the 4-byte ones. Its bar (chip_smoke.py's LOWP_TC_RTOL): the
# tensor cores' fp32 sums are not a sequence of IEEE adds; twice the worst
# measured at llama-350m's shapes
LOWP_TC_RTOL = 4e-6
BF16_PROJECT_SHAPES = {"ragged-m": (300, 256), "ragged-mn": (2, 129, 260),
                       "odd-n": (2, 129, 131), "one-column": (5, 1),
                       "k-tail": (3, 140, 1000)}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", list(BF16_PROJECT_SHAPES))
def test_cuda_dct_project_bf16_ragged(cuda, name, offset):
    """S at LOWP_TC_RTOL of max |S| and the norms at 1e-5 of the plain
    version, relaunches bit-identical; ``offset`` 1 puts G 4 bytes off 16
    (the 4-byte copies)."""
    *batch, m, n = BF16_PROJECT_SHAPES[name]
    size = int(np.prod(batch, dtype=int)) * m * n
    flat = torch.from_numpy(_rand(offset + size, 11)).to(cuda)
    g = flat[offset:].view(*batch, m, n)
    q = dct2_matrix(n, device=cuda)
    before = dp.dct_project_bf16.launches
    s, norms = dp.dct_project(g, q, compute_dtype="bf16")
    again = dp.dct_project_bf16(g, q)
    s_p, norms_p = dp.dct_project_plain(g, q, compute_dtype="bf16")
    torch.cuda.synchronize()
    assert dp.dct_project_bf16.launches == before + 2
    assert torch.equal(s, again[0]) and torch.equal(norms, again[1])
    _assert_rel_max(s, s_p, LOWP_TC_RTOL)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", list(BF16_PROJECT_SHAPES))
def test_cuda_dct_project_f32_ragged(cuda, name, offset):
    """The fp32 kernel at ragged shapes: S within 1e-5 of max |S| of the
    plain version, the norms at 1e-5, a relaunch bit-identical; ``offset``
    1 puts G 4 bytes off 16 (the 4-byte copies)."""
    *batch, m, n = BF16_PROJECT_SHAPES[name]
    size = int(np.prod(batch, dtype=int)) * m * n
    flat = torch.from_numpy(_rand(offset + size, 12)).to(cuda)
    g = flat[offset:].view(*batch, m, n)
    q = dct2_matrix(n, device=cuda)
    before = dp.dct_project.launches
    s, norms = dp.dct_project(g, q)
    again = dp.dct_project(g, q)
    s_p, norms_p = dp.dct_project_plain(g, q)
    torch.cuda.synchronize()
    assert dp.dct_project.launches == before + 2
    assert torch.equal(s, again[0]) and torch.equal(norms, again[1])
    _assert_rel_max(s, s_p, 1e-5)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", list(BF16_PROJECT_SHAPES))
def test_cuda_dct_project_q8_ragged(cuda, name, offset):
    """The int8 route at ragged shapes: its quantizers' codes and scales
    equal ``lowp.quant_rows`` / ``quant_cols`` (transposed), S equal to the
    plain version bit for bit, the norms at 1e-5, the kernel relaunched on
    codes ``offset`` bytes off 16 (1: the byte copies; the route's own codes
    take the 16-byte copies where n % 16 == 0, else the 4-byte or byte
    ones) bit-identical, each launch counted once on its own name."""
    from repro_torch.kernels import lowp
    *batch, m, n = BF16_PROJECT_SHAPES[name]
    size = int(np.prod(batch, dtype=int)) * m * n
    flat = torch.from_numpy(_rand(offset + size, 13)).to(cuda)
    g = flat[offset:].view(*batch, m, n)
    g[..., 0, :] = 0.0                              # zero and subnormal rows
    if m > 1:
        g[..., 1, :] = 1e-40
    q = dct2_matrix(n, device=cuda)
    ops.reset_launch_counts()
    s, norms = dp.dct_project(g, q, compute_dtype="int8")
    gq, sg = lowp.quant_rows(g)
    qq, sq = lowp.quant_cols(q)
    codes = torch.empty(offset + gq.numel(), dtype=torch.int8, device=cuda)
    gq_off = codes[offset:].view(gq.shape)
    gq_off.copy_(gq)
    again = dp.dct_project_q8t(gq_off, sg, qq.T.contiguous(), sq)
    assert ops.launch_counts() == {
        k: (2 if k == "dct_project_q8" else
            1 if k in ("quant_rows_q8", "quant_cols_q8t") else 0)
        for k in ops.KERNELS}
    s_p, norms_p = dp.dct_project_q8_plain(gq, sg, qq, sq)
    q_rows, s_rows = qe.quant_rows_q8(g)
    q_cols, s_cols = qe.quant_cols_q8t(q)
    torch.cuda.synchronize()
    assert torch.equal(q_rows, gq) and torch.equal(s_rows, sg)
    assert torch.equal(q_cols, qq.T) and torch.equal(s_cols, sq)
    assert torch.equal(s, s_p)
    assert torch.equal(s, again[0]) and torch.equal(norms, again[1])
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)


# the colgathers at BF16_PROJECT_SHAPES' ragged (..., m, n), r from part
# of one k slice to several
BF16_GATHER_RANKS = [8, 17, 40, 45, 128]
# each precision's launch counters (dual, single) and its bar against the
# plain version relative to max |out|: fp32 sums in another order than
# cuBLAS; bf16 on the tensor cores; int8 bit-equal (None)
GATHER_PRECISIONS = {
    "fp32": (("colgather_matmul_dual", "colgather_matmul"), 1e-5),
    "bf16": (("colgather_matmul_dual_bf16", "colgather_matmul_bf16"),
             LOWP_TC_RTOL),
    "int8": (("colgather_matmul_dual_q8", "colgather_matmul_q8"), None)}
# the int8 route's operand quantizers, one launch each per call
GATHER_QUANTIZERS = ("quant_qt_q8", "quant_fold_q8")


def _at_offset(cuda, values: np.ndarray, offset: int) -> torch.Tensor:
    """``values`` on the card, ``offset`` floats past a 16-byte boundary."""
    flat = torch.zeros(offset + values.size, device=cuda)
    flat[offset:] = torch.from_numpy(values.ravel()).to(cuda)
    return flat[offset:].view(values.shape)


def _codes_at(codes: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of int8 ``codes`` ``offset`` bytes past a 16-byte boundary."""
    flat = torch.zeros(offset + codes.numel(), dtype=torch.int8,
                       device=codes.device)
    flat[offset:] = codes.reshape(-1)
    return flat[offset:].view(codes.shape)


def _assert_gather_close(got, want, tol):
    if tol is None:
        assert torch.equal(got, want)
    else:
        _assert_rel_max(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", list(GATHER_PRECISIONS))
@pytest.mark.parametrize("r", BF16_GATHER_RANKS)
@pytest.mark.parametrize("name", list(BF16_PROJECT_SHAPES))
def test_cuda_colgather_bf16_ragged(cuda, name, r, precision):
    """Each precision's dual and single against their plain versions
    (GATHER_PRECISIONS' bar), relaunches bit-identical, the single equal to
    the dual's first output bit for bit, each launch counted once on its
    precision's names (int8: its two quantizers once per call); with b 4
    bytes off 16 (the 4-byte copies) the same bits again; int8 also on
    codes 4 and 1 bytes off 16 (the 4-byte copies and the byte loads)."""
    *batch, m, n = BF16_PROJECT_SHAPES[name]
    r = min(r, n)
    (dual_name, single_name), tol = GATHER_PRECISIONS[precision]
    b1_np, b2_np = _rand((*batch, m, r), 21), _rand((*batch, m, r), 22)
    qt = dct2_matrix(n, device=cuda).T.contiguous()
    idx = torch.from_numpy(_idx(batch, n, r, 23)).to(cuda)
    outs = []
    for offset in (0, 1):
        b1, b2 = _at_offset(cuda, b1_np, offset), _at_offset(cuda, b2_np, offset)
        ops.reset_launch_counts()
        o1, o2 = cg.colgather_matmul_dual(b1, b2, qt, idx,
                                          compute_dtype=precision)
        again = cg.colgather_matmul_dual(b1, b2, qt, idx,
                                         compute_dtype=precision)
        single = cg.colgather_matmul(b1, qt, idx, compute_dtype=precision)
        single2 = cg.colgather_matmul(b1, qt, idx, compute_dtype=precision)
        p1, p2 = cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                compute_dtype=precision)
        torch.cuda.synchronize()
        quantizers = 4 if precision == "int8" else 0
        assert ops.launch_counts() == {
            k: 2 if k in (dual_name, single_name)
            else quantizers if k in GATHER_QUANTIZERS else 0
            for k in ops.KERNELS}
        assert torch.equal(o1, again[0]) and torch.equal(o2, again[1])
        assert torch.equal(single, single2) and torch.equal(single, o1)
        _assert_gather_close(o1, p1, tol)
        _assert_gather_close(o2, p2, tol)
        outs.append((o1, o2))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    if precision == "int8":
        ((q1, s1), (q2, s2)), qt_q = cg.quantize_operands((b1, b2), qt, idx)
        for code_offset in (4, 1):
            c1, c2 = _codes_at(q1, code_offset), _codes_at(q2, code_offset)
            cq = _codes_at(qt_q, code_offset)
            d1, d2 = cg.colgather_matmul_dual_q8(c1, s1, c2, s2, cq, idx)
            one = cg.colgather_matmul_q8(c1, s1, cq, idx)
            torch.cuda.synchronize()
            assert torch.equal(d1, o1) and torch.equal(d2, o2)
            assert torch.equal(one, o1)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", list(GATHER_PRECISIONS))
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_colgather_bf16_repeated_and_bad_indices(cuda, offset,
                                                      precision):
    """A repeated index gathers its row twice; an index outside [0, n)
    gathers a zero row (a zero column of Q_r), reading nothing outside Qt:
    both outputs within GATHER_PRECISIONS' bar of the product on such a
    gather. int8 bit-equal to the plain version on Q^T with a zero row
    appended, the bad indices pointing at it (its scale F32_TINY folded
    into b)."""
    from repro_torch.kernels.lowp import bf16_round, int_matmul, quant_rows
    from repro_torch.kernels.quant_ef import quant_fold_q8_plain
    (dual_name, _), tol = GATHER_PRECISIONS[precision]
    m, n, r = 130, 260, 40
    b1 = _at_offset(cuda, _rand((2, m, r), 31), offset)
    b2 = _at_offset(cuda, _rand((2, m, r), 32), offset)
    qt = torch.from_numpy(_rand((n, n), 33)).to(cuda)
    idx_np = _idx((2,), n, r, 34)
    idx_np[0, :4] = [-1, n, n + 7, -(2**31)]
    idx_np[1, 5:9] = idx_np[1, 4]                    # one row four times
    idx_np[1, 20] = 2**31 - 1
    idx = torch.from_numpy(idx_np).to(cuda)
    bad = (idx < 0) | (idx >= n)
    if precision == "int8":
        rows = torch.where(bad, n, idx).long()      # the appended zero row
        qt_q, s_qt = quant_rows(torch.cat([qt, torch.zeros_like(qt[:1])]))

        def want(b):
            ((bq, sb),) = quant_fold_q8_plain((b,), s_qt, rows)
            return int_matmul(bq, qt_q[rows]) * sb
    else:
        cast = bf16_round if precision == "bf16" else (lambda x: x)
        gathered = qt[idx.clamp(0, n - 1).long()]
        gathered[bad] = 0.0
        gathered = cast(gathered)

        def want(b):
            return cast(b) @ gathered
    before = getattr(cg, dual_name).launches
    o1, o2 = cg.colgather_matmul_dual(b1, b2, qt, idx, compute_dtype=precision)
    single = cg.colgather_matmul(b1, qt, idx, compute_dtype=precision)
    torch.cuda.synchronize()
    assert getattr(cg, dual_name).launches == before + 1
    for got, b in ((o1, b1), (o2, b2), (single, b1)):
        _assert_gather_close(got, want(b), tol)
    assert torch.equal(single, o1)


# the paper's baselines: (preset, keywords, kernel launches of one update
# of the two matrix leaves below). On the card fused "auto" runs the kernels
# for a basis backend; the dense kinds run torch.linalg and no kernel.
BASELINES = {
    "ldadamw": ("ldadamw", {}, {}),
    "galore": ("galore", {}, {}),
    "galore dct": ("galore", {"projector": "dct"},
                   {"dct_project": 2, "colgather_matmul": 2}),
    "frugal": ("frugal", {}, {}),
    "frugal dct": ("frugal", {"projector": "dct"},
                   {"dct_project": 2, "colgather_matmul_dual": 2}),
    "frugal random": ("frugal", {"projector": "random"}, {}),
    "frugal randperm": ("frugal", {"projector": "randperm"}, {}),
    "fira": ("fira", {}, {}),
    "fira dct": ("fira", {"projector": "dct"},
                 {"dct_project": 2, "colgather_matmul_dual": 2}),
    "adamw": ("adamw", {}, {}),
}
BASELINE_RANK = 6


def _baseline_grad(shape, seed, dct: bool):
    """A gradient whose top-r subspace is well defined: singular values
    10 * 0.7^k (the dense kinds), or r of the DCT columns 8x the rest (the
    dct projector), in the oriented layout (n last), handed over in the
    parameter's."""
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    flip = n > m
    if flip:
        m, n = n, m
    out = np.empty((*batch, m, n))
    q = dct2_matrix(n, dtype=torch.float64).numpy()
    for b in np.ndindex(*batch):
        if dct:
            scale = np.full(n, 0.125)
            scale[rng.permutation(n)[:BASELINE_RANK]] = 1.0
            out[b] = (rng.standard_normal((m, n)) * scale) @ q.T
        else:
            u, _ = np.linalg.qr(rng.standard_normal((m, n)))
            v, _ = np.linalg.qr(rng.standard_normal((n, n)))
            out[b] = (u * (10.0 * 0.7 ** np.arange(n))) @ v.T
    out = np.swapaxes(out, -1, -2) if flip else out
    return torch.from_numpy(np.ascontiguousarray(out, dtype=np.float32))


def _tensors(tree):
    """Every tensor of a state or update tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BASELINES))
def test_cuda_baseline_update_matches_cpu(cuda, monkeypatch, case):
    """One update of each baseline from its init state, on the card against
    the CPU: rtol 1e-4 and atol 1e-4 of max |u| (fp32 sums in other orders;
    cuSOLVER's and LAPACK's singular vectors may differ in sign, which a
    refresh from zero moments does not see). The random kinds draw from the
    CPU generator on both, moved to the device, so the draws are equal. No
    tensor of the result leaves the card, and only the dct variants launch
    kernels."""
    from repro_torch.core import projectors
    from repro_torch.optim.api import get_optimizer

    name, kw, launches = BASELINES[case]
    draw_n, draw_p = projectors.gaussian_draw, projectors.permutation_draw
    monkeypatch.setattr(projectors, "gaussian_draw",
                        lambda key, shape, device: draw_n(key, shape, "cpu")
                        .to(device))
    monkeypatch.setattr(projectors, "permutation_draw",
                        lambda key, n, device: draw_p(key, n, "cpu")
                        .to(device))
    if name != "adamw":
        kw = dict(kw, rank=BASELINE_RANK)
    dct = kw.get("projector") == "dct"
    params = {"a/kernel": _baseline_grad((3, 40, 24), 1, False),
              "b/kernel": _baseline_grad((24, 48), 2, False),
              "final_norm/scale": torch.ones(24)}
    grads = {"a/kernel": _baseline_grad((3, 40, 24), 3, dct),
             "b/kernel": _baseline_grad((24, 48), 4, dct),
             "final_norm/scale": torch.linspace(-1, 1, 24)}
    out = {}
    for dev in ("cpu", cuda):
        opt = get_optimizer(name, lr=0.01, **kw)
        p = {k: v.to(dev) for k, v in params.items()}
        state = opt.init(p)
        before = ops.launch_counts()
        u, state = opt.update({k: v.to(dev) for k, v in grads.items()},
                              state, p)
        got = {k: n - before[k] for k, n in ops.launch_counts().items() if
               n != before[k]}
        out[str(dev)] = u
    torch.cuda.synchronize()
    assert got == launches, got
    assert all(t.device.type == "cuda" for t in _tensors((u, state))), case
    for k, want in out["cpu"].items():
        torch.testing.assert_close(out[str(cuda)][k].cpu(), want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


# the DeepSeek MoE family's new shapes: (q / k head dim, v head dim) of the
# blockwise kernel (MLA's 192 / 128; a small pair each way), and the
# optimizer kernels on a 4-D expert leaf (layers, experts, m, n) with n =
# 1408 (deepseek-moe-16b's expert hidden) and at r = n = 64 (its router:
# every column kept)
BLOCKWISE_VD = {"mla": (192, 128), "narrow v": (48, 32), "wide v": (64, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BLOCKWISE_VD))
def test_cuda_blockwise_kernel_own_value_dim(cuda, name):
    """``flash_attention_blockwise`` with v of its own head dim against the
    plain loop at the model's bar (tests/test_torch_layers.py's: max |d| <=
    4e-3 max |out|, >= 99% bit-equal), relaunched bit-identical; MLA's
    shapes at 8 heads, causal, two kv chunks."""
    hd, vd = BLOCKWISE_VD[name]
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k = (torch.randn(2, 256, 8, hd, device=cuda, generator=gen).bfloat16()
            for _ in range(2))
    v = torch.randn(2, 256, 8, vd, device=cuda, generator=gen).bfloat16()
    kw = dict(causal=True, kv_chunk=128)
    before = fa.flash_attention_blockwise.launches
    got = fa.flash_attention_blockwise(q, k, v, **kw)
    again = fa.flash_attention_blockwise(q, k, v, **kw)
    want = fa.blockwise_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_blockwise.launches == before + 2
    assert got.shape == (2, 256, 8, vd) and torch.equal(got, again)
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= 4e-3 * want.float().abs().max().item()
    assert (d == 0).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((2, 3, 1536, 1408), 128),
                                     ((2, 3, 200, 64), 64)])
def test_cuda_projection_kernels_on_expert_leaves(cuda, shape, r):
    """``dct_project`` and ``colgather_matmul_dual`` on a 4-D (layers,
    experts, m, n) leaf against their plain versions (fp32 sums in another
    order: rtol 1e-5), n = 1408 and r = n = 64 (every column)."""
    *batch, m, n = shape
    g = torch.from_numpy(_rand(shape, 12)).to(cuda)
    q = dct2_matrix(n, device=cuda)
    s, norms = dp.dct_project(g, q)
    s_p, norms_p = dp.dct_project_plain(g, q)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)
    idx = torch.from_numpy(_idx(batch, n, r, 13)).to(cuda)
    b1 = torch.from_numpy(_rand((*batch, m, r), 14)).to(cuda)
    b2 = torch.from_numpy(_rand((*batch, m, r), 15)).to(cuda)
    qt = q.T.contiguous()
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 24), (24, 64, 32), (8192, 16),
                                   (16384, 9)])
def test_cuda_kernels_on_stacked_vector_leaves(cuda, shape):
    """The four DCT-AdamW kernels at the narrow leaves of the recurrent
    families (rwkv6's stacked mixes, n = 24, and ``bonus_u``, n = 32;
    jamba's router, n = 16, and full-depth ``d_skip``, n = 9: off the bf16
    K step of 16 and odd), every column selected (r = n), against their
    plain versions: fp32 at 1e-5, bf16 ``dct_project`` at LOWP_RTOL and the
    bf16 colgather at LOWP_TC_RTOL of max |out|, int8 bit for bit; and the
    "fft" route's S (the Makhoul transform, at odd n too) within 1e-5 of
    the kernel's."""
    from repro_torch.core.dct import makhoul_dct2
    from repro_torch.kernels import lowp
    *batch, m, n = shape
    g = torch.from_numpy(_rand(shape, 16)).to(cuda)
    q = dct2_matrix(n, device=cuda)
    qt = q.T.contiguous()
    s, norms = dp.dct_project(g, q)
    s_p, norms_p = dp.dct_project_plain(g, q)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(norms, norms_p, rtol=1e-5, atol=0)
    _assert_rel_max(makhoul_dct2(g), s_p, 1e-5)
    idx = torch.arange(n, dtype=torch.int32, device=cuda).expand(
        *batch, n).contiguous()
    b1 = torch.from_numpy(_rand((*batch, m, n), 17)).to(cuda)
    b2 = torch.from_numpy(_rand((*batch, m, n), 18)).to(cuda)
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    qk, sk = qe.quantize_ef(g)
    qp, sp = qe.quantize_ef_plain(g)
    assert torch.equal(sk, sp) and (qk.int() - qp.int()).abs().max() <= 1
    assert torch.equal(qe.dequant_add_ef(g, qk, sk),
                       qe.dequant_add_ef_plain(g, qk, sk))
    s, _ = dp.dct_project(g, q, compute_dtype="bf16")
    _assert_rel_max(s, dp.dct_project_plain(g, q, compute_dtype="bf16")[0],
                    LOWP_RTOL)
    gq, sg = lowp.quant_rows(g)
    qq, sq = lowp.quant_cols(q)
    assert torch.equal(dp.dct_project(g, q, compute_dtype="int8")[0],
                       dp.dct_project_q8_plain(gq, sg, qq, sq)[0])
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx,
                                             compute_dtype="bf16"),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                   compute_dtype="bf16")):
        _assert_rel_max(a, b, LOWP_TC_RTOL)
    for a, b in zip(cg.colgather_matmul_dual(b1, b2, qt, idx,
                                             compute_dtype="int8"),
                    cg.colgather_matmul_dual_plain(b1, b2, qt, idx,
                                                   compute_dtype="int8")):
        assert torch.equal(a, b)


# the encoder-decoder and cross-attention families: both prefill kernels at
# keys of their own length, without a mask (b, sq, skv, hq, hkv, hd, kv
# chunk): whisper-large-v3's cross-attention (448 queries against its 1500
# frames; 1500 is no multiple of the kernels' 64-key tiles), its encoder
# (1500 against 1500, bidirectional), llama-3.2-vision-90b's cross-attention
# (2048 queries against 6400 image tokens, GQA 8, one chunk of 6400), each
# cut to 4 query heads; fewer keys than queries; one query
SKV_CASES = {"whisper cross": (2, 448, 1500, 4, 4, 64, 1024),
             "whisper encoder": (1, 1500, 1500, 4, 4, 64, 1024),
             "vision cross": (1, 2048, 6400, 8, 1, 128, 1024),
             "short keys": (2, 300, 70, 4, 2, 64, 512),
             "one query": (3, 1, 777, 4, 2, 64, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SKV_CASES))
def test_cuda_attention_kernels_keys_of_their_own_length(cuda, name):
    """``flash_attention`` (fp32, within 3e-5 of its plain version) and
    ``flash_attention_blockwise`` (bf16: max |d| <= 2 bf16 ulps of max
    |out|, the bar of ``chip_smoke.py``'s per-layer prefill check, and >=
    98% bit-equal) with Skv != Sq and no mask, each relaunched
    bit-identical; a causal call with keys of another length is refused.
    The ulps and 98%, not 4e-3 of max |out| and 99%: over 6400 keys the
    outputs are small averages, more of their last roundings land near a
    bf16 boundary, and max |out| may sit low in its binade, where one
    output that rounds to its neighbour is more than 4e-3 of it (measured
    at 2048 x 6400: one ulp, 4.9e-4 of 0.116; 98.6% bit-equal)."""
    b, sq, skv, hq, hkv, hd, chunk = SKV_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(29)
    q = torch.randn(b, sq, hq, hd, device=cuda, generator=gen)
    k, v = (torch.randn(b, skv, hkv, hd, device=cuda, generator=gen)
            for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=False)
    again = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, again)
    assert (got - want).abs().max().item() <= 3e-5
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    kw = dict(causal=False, kv_chunk=chunk)
    got = fa.flash_attention_blockwise(q16, k16, v16, **kw)
    again = fa.flash_attention_blockwise(q16, k16, v16, **kw)
    want = fa.blockwise_attention_ref(q16, k16, v16, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.equal(got, again)
    d = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    assert d.max().item() <= 2 * ulp.item()
    assert (d == 0).float().mean().item() >= 0.98
    if sq != skv:
        with pytest.raises(ValueError, match="keys of their own length"):
            fa.flash_attention_blockwise(q16, k16, v16, causal=True)
