"""Newton–Schulz of the port against the JAX package's, and the
single-operand column-gather back-projection.

On the CPU the port's kernel path (``kernels/newton_schulz.py``) runs the
gram and apply kernels' plain versions; it is held against the JAX package's
Pallas iteration in interpret mode and its jnp iteration on the same numpy
inputs, over the shapes of ``tests/test_newton_schulz_properties.py``. The
properties of that file (Gram near identity, singular-value band,
near-singular inputs) are checked on the port's own results. The CUDA
kernels against these plain versions are in ``test_torch_cuda.py``.
"""
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused_step as jfs
from repro.core.dct import dct2_matrix as jax_dct2
from repro.core.newton_schulz import newton_schulz as jax_newton_schulz
from repro.kernels import ops as jops
from repro.kernels.newton_schulz import newton_schulz_pallas
from repro.kernels.newton_schulz import ns_iteration as jax_ns_iteration
from repro_torch.core import fused_step
from repro_torch.core.dct import dct2_matrix
from repro_torch.core.newton_schulz import NS_COEFFS, newton_schulz
from repro_torch.kernels import newton_schulz as ns
from repro_torch.kernels import ops
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
cg = importlib.import_module("repro_torch.kernels.colgather_matmul")

# tall factors (the trion / subspace-muon case), wide, layer-stacked, odd
# dims, tall with rows no block multiple, and r > rows
SHAPES = [(64, 16), (16, 64), (3, 64, 16), (33, 80), (100, 12), (8, 64)]

# One iteration: the same products summed in other orders (Pallas column
# blocks, XLA's and PyTorch's matmuls), measured <= 8.2e-7 of max |out|.
ITER_RTOL = 1e-5
# Five iterations: the quintic's slope at 0 is a = 3.4445, so a relative
# difference in a small singular direction can grow up to a^5 ~ 500x over
# the iteration; measured <= 2.4e-6 of max |out| over SHAPES (the JAX
# package's own Pallas-vs-jnp test allows 1e-3).
NS_RTOL = 1e-4
# NS5 bands singular values instead of driving them to 1
# (tests/test_newton_schulz_properties.py)
OFFDIAG_TOL = 0.35
SV_LO, SV_HI = 0.3, 1.35


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _singular_values(y: np.ndarray) -> np.ndarray:
    return np.linalg.svd(y.reshape(-1, *y.shape[-2:]).astype(np.float64),
                         compute_uv=False)


def _wide(shape):
    *b, p, q = shape
    return (*b, p, q) if p <= q else (*b, q, p)


@pytest.mark.parametrize("shape", SHAPES)
def test_ns_iteration_matches_jax_pallas(shape):
    x = _rand(_wide(shape), seed=sum(shape), scale=0.1)
    before = ops.launch_counts()
    got = ns.ns_iteration(torch.from_numpy(x)).numpy()
    assert ops.launch_counts() == before            # CPU: plain versions
    want = np.asarray(jax_ns_iteration(jnp.asarray(x), bm=32, interpret=True))
    _close(got, want, ITER_RTOL)


# the ranks the apply kernel's tests cover on the card, each on a ragged
# wide factor (r, m), scaled like the first iteration's input
APPLY_RANKS = {8: 100, 17: 333, 45: 1000, 128: 300, 300: 333, 512: 600}


@pytest.mark.parametrize("r", list(APPLY_RANKS))
def test_ns_iteration_matches_jax_pallas_at_ranks(r):
    x = _rand((r, APPLY_RANKS[r]), seed=r)
    x /= np.linalg.norm(x)
    got = ns.ns_iteration(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ns_iteration(jnp.asarray(x), bm=256,
                                       interpret=True))
    _close(got, want, ITER_RTOL)


def test_ns_apply_smem_fits_every_routed_rank():
    """Every r that fused_step routes to the kernels gets a launch within a
    block's shared memory; APPLY_MAX_RANK is the largest r that does."""
    assert ns.APPLY_MAX_RANK >= fused_step.NS_KERNEL_MAX_RANK
    for r in range(1, fused_step.NS_KERNEL_MAX_RANK + 1):
        assert ns.ns_apply_smem_bytes(r) <= ns.SMEM_PER_BLOCK, r
    assert ns.ns_apply_smem_bytes(ns.APPLY_MAX_RANK) <= ns.SMEM_PER_BLOCK
    assert ns.ns_apply_smem_bytes(ns.APPLY_MAX_RANK + 1) > ns.SMEM_PER_BLOCK
    # three CTAs per SM (228 KB, 1 KB reserved per block) at Trion's r
    assert 3 * (ns.ns_apply_smem_bytes(128) + 1024) <= 228 * 1024


def test_ns_apply_smem_mirrors_the_kernel_source():
    """``ns_apply_smem_bytes`` recomputed from the constants of the apply
    kernel's source: its P ring (two slices as they arrive, two transposed)
    and X's stripe, r padded to the slice."""
    import re
    from pathlib import Path
    src = (Path(ns.__file__).resolve().parent.parent / "csrc"
           / "newton_schulz.cu").read_text()
    body = src[src.index("namespace apply {"):src.index("}  // namespace apply")]
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", body)}
    pad = int(re.search(r"constexpr int kLdT = BM \+ (\d+);", body).group(1))
    bm, bn, bk = const["BM"], const["BN"], const["BK"]
    for r in (1, 17, 128, 500, 512, ns.APPLY_MAX_RANK):
        ring = 4 * (2 * bm * bk + 2 * bk * (bm + pad))
        stripe = 4 * bn * (-(-r // bk) * bk)
        assert ns.ns_apply_smem_bytes(r) == ring + stripe, r


def _gram_consts() -> dict:
    import re
    src = (Path(ns.__file__).resolve().parent.parent / "csrc"
           / "newton_schulz.cu").read_text()
    body = src[src.index("namespace gram {"):src.index("}  // namespace gram")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", body)}


def test_ns_gram_geometry_mirrors_the_kernel_source():
    """The wrapper's split and workspace use the Gram kernel's block, macro
    tile, k slice, largest split and warps per CTA; Trion's m (1024, 2816)
    take 16 ranges, and its (24, 128, m) factors a workspace of 16 x 5
    warps' 32 x 64 partials per layer."""
    import re
    const = _gram_consts()
    assert (ns.GRAM_BLOCK, ns.GRAM_MACRO, ns.GRAM_SLICE, ns.GRAM_MAX_SPLITS) \
        == (const["BB"], const["kMacro"], const["BK"], const["kMaxSplits"])
    src = (Path(ns.__file__).resolve().parent.parent / "csrc"
           / "newton_schulz.cu").read_text()
    table = re.search(r"constexpr int kWarpsOf =\s*([^;]+);", src).group(1)
    warps = {int(rows): int(w) for rows, w in
             re.findall(r"kRows == (\d+) \? (\d+)", table)}
    warps_past = int(table.rsplit(":", 1)[1])
    assert re.search(r"constexpr int kPartFloats = BB \* 2 \* BB;", src)
    part = 2 * const["BB"] ** 2
    for r in range(1, 600):
        blocks = -(-r // const["BB"])
        if blocks <= const["kMacro"]:
            tiles, w = 1, warps[const["BB"] * blocks]
        else:
            n = -(-blocks // const["kMacro"])
            tiles, w = n * (n + 1) // 2, warps_past
        assert ns.ns_gram_workspace_floats(3, r, 7) == 3 * tiles * 7 * w * part
    assert ns.ns_gram_splits(24, 128, 1024) == (16, 64)
    assert ns.ns_gram_splits(24, 128, 2816) == (16, 176)
    assert ns.ns_gram_workspace_floats(24, 128, 16) == 24 * 16 * 5 * part


@pytest.mark.parametrize("batch, r", [(1, 8), (24, 128), (2, 300),
                                      (24, 512), (1000, 64)])
@pytest.mark.parametrize("m", [0, 1, 37, 64, 100, 333, 1030, 4096,
                               100_000])
def test_ns_gram_splits_meet_the_entry_point(batch, r, m):
    """What ``repro_ns_gram`` accepts: 1 <= splits <= GRAM_MAX_SPLITS, width
    a positive multiple of the k slice, splits * width >= m; no range
    empty, none short of GRAM_SPLIT_MIN_COLS columns but where m is; the
    CTAs no more than GRAM_CTAS but where one range per tile exceeds it."""
    splits, width = ns.ns_gram_splits(batch, r, m)
    assert 1 <= splits <= ns.GRAM_MAX_SPLITS
    assert width > 0 and width % ns.GRAM_SLICE == 0
    assert splits * width >= m and (splits - 1) * width < max(m, 1)
    assert splits == 1 or width >= ns.GRAM_SPLIT_MIN_COLS
    ctas = batch * ns._gram_tiles(r)[0]
    assert splits == 1 or ctas * splits <= ns.GRAM_CTAS


@pytest.mark.parametrize("r", list(APPLY_RANKS))
def test_ns_gram_matches_jax_gram_kernel(r):
    """The Gram on the CPU (the kernel's plain version) against the JAX
    package's ``_gram_kernel`` in interpret mode, over column blocks of 128
    (zero-padded), on a stacked ragged factor: the same products summed in
    other orders, within ITER_RTOL of max |A|."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from repro.kernels import newton_schulz as jns
    m, bm = APPLY_RANKS[r], 128
    x = _rand((2, r, m), seed=r + 1)
    x /= np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    xp = np.pad(x, ((0, 0), (0, 0), (0, -m % bm)))
    nk = xp.shape[-1] // bm
    want = pl.pallas_call(
        functools.partial(jns._gram_kernel, nk=nk), grid=(2, nk),
        in_specs=[pl.BlockSpec((1, r, bm), lambda bi, k: (bi, 0, k))],
        out_specs=pl.BlockSpec((1, r, r), lambda bi, k: (bi, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2, r, r), jnp.float32),
        scratch_shapes=[pltpu.VMEM((r, r), jnp.float32)],
        interpret=True)(jnp.asarray(xp))
    got = ns.ns_gram(torch.from_numpy(x))
    assert got.shape == (2, r, r)
    _close(got.numpy(), np.asarray(want), ITER_RTOL)


def test_ns_apply_cpu_has_no_envelope():
    """The plain version takes an r past the kernel's envelope."""
    a = NS_COEFFS[0]
    r = ns.APPLY_MAX_RANK + 16
    x = torch.from_numpy(_rand((r, r + 3), seed=3, scale=0.01))
    p = torch.from_numpy(_rand((r, r), seed=4, scale=0.01))
    torch.testing.assert_close(ns.ns_apply(x, p, a=a),
                               ns.ns_apply_plain(x, p, a), rtol=0, atol=0)


def test_ns_iteration_matches_polynomial():
    """One iteration == a*X + (b*G + c*G^2) X literally (float64)."""
    a, b, c = NS_COEFFS
    x = _rand((16, 96), seed=7, scale=0.1).astype(np.float64)
    g = x @ x.T
    want = a * x + (b * g + c * g @ g) @ x
    got = ns.ns_iteration(torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("steps", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_newton_schulz_kernel_path_matches_jax(shape, steps):
    x = _rand(shape, seed=sum(shape) + steps)
    got = ns.newton_schulz_kernel(torch.from_numpy(x), steps=steps)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    want = np.asarray(newton_schulz_pallas(jnp.asarray(x), steps=steps,
                                           bm=32, interpret=True))
    _close(got.numpy(), want, NS_RTOL)


@pytest.mark.parametrize("steps", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_core_newton_schulz_matches_jax(shape, steps):
    x = _rand(shape, seed=sum(shape) + steps)
    got = newton_schulz(torch.from_numpy(x), steps=steps).numpy()
    want = np.asarray(jax_newton_schulz(jnp.asarray(x), steps=steps))
    _close(got, want, NS_RTOL)
    # the plain kernel path composes exactly the core iteration
    np.testing.assert_array_equal(
        ns.newton_schulz_kernel(torch.from_numpy(x), steps=steps).numpy(), got)


@pytest.mark.parametrize("steps", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_gram_near_identity(shape, steps):
    y = newton_schulz(torch.from_numpy(_rand(shape, seed=sum(shape))),
                      steps=steps).numpy().astype(np.float64)
    g = (np.einsum("...ki,...kj->...ij", y, y) if y.shape[-2] >= y.shape[-1]
         else np.einsum("...ik,...jk->...ij", y, y))
    off = np.abs(g * (1.0 - np.eye(g.shape[-1]))).max()
    assert off < OFFDIAG_TOL, (shape, steps, off)
    sv = _singular_values(y)
    assert SV_LO < sv.min() and sv.max() < SV_HI, (shape, steps)


@pytest.mark.parametrize("kind", ["rank_deficient", "dup_columns", "tiny"])
def test_near_singular_inputs_stay_finite(kind):
    x = _rand((64, 16), seed=3)
    if kind == "rank_deficient":
        x[:, 8:] = 0.0
    elif kind == "dup_columns":
        x[:, 1] = x[:, 0]
    else:
        x = x * np.float32(1e-20)
    for steps in (3, 5):
        for fn in (newton_schulz, ns.newton_schulz_kernel):
            y = fn(torch.from_numpy(x), steps=steps).numpy().astype(np.float64)
            assert np.isfinite(y).all(), (kind, steps)
            sv = _singular_values(y)
            assert sv.max() < SV_HI, (kind, steps, sv.max())
            if kind != "tiny":
                live = sv[sv > 1e-3]
                assert live.size and live.min() > SV_LO, (kind, steps)
        want = np.asarray(jax_newton_schulz(jnp.asarray(x), steps=steps))
        _close(newton_schulz(torch.from_numpy(x), steps=steps).numpy(), want,
               NS_RTOL)


def test_fused_newton_schulz_modes():
    """"off" and "fft" are the core iteration; "on" is the kernel path;
    ZeRO gather axes need an active mesh (``test_torch_zero.py`` runs
    them), and raise without one."""
    x = torch.from_numpy(_rand((3, 64, 16), seed=11))
    core = newton_schulz(x, steps=5)
    for mode in ("off", "fft"):
        assert torch.equal(fused_step.fused_newton_schulz(
            x, steps=5, mode=mode, gather_axes=None), core)
    assert torch.equal(fused_step.fused_newton_schulz(x, steps=5, mode="on"),
                       ns.newton_schulz_kernel(x, steps=5))
    with pytest.raises(RuntimeError, match="active mesh"):
        fused_step.fused_newton_schulz(x, steps=5, mode="on",
                                       gather_axes=("data",))


def test_newton_schulz_keeps_dtype_and_orientation():
    x = torch.from_numpy(_rand((2, 40, 8), seed=5)).to(torch.bfloat16)
    for fn in (newton_schulz, ns.newton_schulz_kernel):
        y = fn(x, steps=3)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape


def test_ns_wrappers_reject_bad_operands():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        ns.ns_apply(x, torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        ns.ns_apply(x, torch.zeros(2, 4, 4), out=x)
    with pytest.raises(ValueError):
        cg.colgather_matmul(torch.zeros(3, 2), torch.zeros(4, 4),
                            torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# colgather_matmul: O = b @ Q^T[idx, :], one operand
# ---------------------------------------------------------------------------
CG_SHAPES = {"2d": (64, 64, 8), "tall": (128, 96, 16), "odd": (50, 130, 10),
             "stacked": (3, 50, 64, 8), "stacked2": (2, 2, 40, 48, 6)}


@pytest.mark.parametrize("name", list(CG_SHAPES))
def test_colgather_matmul_plain_matches_jax(name):
    *batch, m, n, r = CG_SHAPES[name]
    b = _rand((*batch, m, r), seed=m)
    rng = np.random.default_rng(r)
    idx = np.stack([np.sort(rng.permutation(n)[:r])
                    for _ in range(int(np.prod(batch, dtype=int)))]
                   ).reshape(*batch, r).astype(np.int32)
    qt = dct2_matrix(n).T.contiguous()
    got = cg.colgather_matmul(torch.from_numpy(b), qt, torch.from_numpy(idx))
    want = jops.colgather_matmul_op(jnp.asarray(b), jnp.asarray(qt.numpy()),
                                    jnp.asarray(idx))
    # r-term fp32 sums in different orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # one operand == either half of the dual kernel
    o1, _ = cg.colgather_matmul_dual(torch.from_numpy(b), torch.from_numpy(b),
                                     qt, torch.from_numpy(idx))
    torch.testing.assert_close(got, o1, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["off", "fft", "on"])
def test_fused_backproject_matches_jax(mode):
    m, n, r = 40, 24, 6
    u = _rand((3, m, r), seed=1)
    idx = np.sort(np.random.default_rng(2).permutation(n)[:r])
    idx = np.stack([idx] * 3).astype(np.int32)
    got = fused_step.fused_backproject(torch.from_numpy(u), dct2_matrix(n),
                                       torch.from_numpy(idx), mode=mode)
    want = jfs.fused_backproject(jnp.asarray(u), jax_dct2(n),
                                 jnp.asarray(idx), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
