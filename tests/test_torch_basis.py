"""DCT-AdamW's other predefined bases against the JAX package: the DST-II,
Walsh–Hadamard and random-orthogonal backends (matrices, the FWHT fast
path, the registry and the BasisCache), DCT-AdamW updates with each basis
from a JAX-built state in every fused mode, and ``--basis hadamard`` /
``randortho`` trajectories of the smoke llama.

``randortho`` draws its Gaussian from a ``torch.Generator``, another stream
than ``jax.random``: the port's matrix is held to its own properties
(orthogonal, deterministic per seed), and where the two packages are run
side by side the JAX matrix is handed to the port — inside the carried
optimizer state, or through ``BasisCache.put``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse

from repro.configs import llama_paper as jax_llama
from repro.core import transforms as jtr
from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.core import transforms as ttr
from repro_torch.core.projectors import Projector, projector_kinds
from repro_torch.launch import train as train_cli
from repro_torch.optim.api import get_optimizer
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup


KINDS = ("dct", "dst", "hadamard", "randortho")
# the matrices: fp32 sin/cos of the same exactly reduced phase in two
# libraries (an ulp or two of the entries), Hadamard's ±1/sqrt(n) exactly
MATRIX_ATOL = 1e-6


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def clean_cache():
    ttr.basis_cache().clear()
    yield ttr.basis_cache()
    ttr.basis_cache().clear()


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------
def test_registry_holds_the_four_kinds():
    assert ttr.backend_kinds() == KINDS == jtr.backend_kinds()
    assert projector_kinds() == KINDS + ("svd", "power", "random", "randperm")
    for kind in KINDS:
        Projector(kind=kind, r=4)
    Projector(kind="svd", r=4)
    with pytest.raises(ValueError, match="unknown projector kind 'wavelet'"):
        Projector(kind="wavelet", r=4)


@pytest.mark.parametrize("n", [8, 17, 40, 64])
@pytest.mark.parametrize("kind", ["dct", "dst", "hadamard"])
def test_basis_matrix_matches_jax(kind, n):
    got = ttr.get_backend(kind).matrix(n)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jtr.get_backend(kind).matrix(n)),
                               atol=MATRIX_ATOL, rtol=0)
    if kind == "hadamard":       # ±1/sqrt(n) entries: bit-equal
        assert np.array_equal(got.numpy(),
                              np.asarray(jtr.hadamard_matrix(n)))


@pytest.mark.parametrize("n", [8, 17, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_backend_matrix_orthonormal(kind, n):
    q = ttr.get_backend(kind).matrix(n).double().numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=5e-6)


def test_dst_order_limit():
    with pytest.raises(ValueError, match="int32-exact"):
        ttr.dst2_matrix(40_000)


def test_fwht_equals_sylvester_matmul_and_jax():
    n = 64
    x = _rand((3, n), 1)
    h = ttr.hadamard_matrix(n).double().numpy() * np.sqrt(n)   # ±1
    got = ttr.fwht(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ h,
                               atol=1e-4)
    # the same butterfly, the same adds in the same order
    assert np.array_equal(got.numpy(), np.asarray(jtr.fwht(jnp.asarray(x))))
    with pytest.raises(ValueError, match="power-of-two"):
        ttr.fwht(torch.zeros(2, 12))


@pytest.mark.parametrize("n", [8, 33, 64, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_fast_matches_matmul_and_jax(kind, n):
    """The FWHT for hadamard at power-of-two n (the matmul at other n),
    Makhoul for dct, the matmul for dst / randortho."""
    be = ttr.get_backend(kind)
    x = _rand((5, n), n)
    q = be.matrix(n)
    fast = be.apply_fast(torch.from_numpy(x), q)
    np.testing.assert_allclose(fast.numpy(), (torch.from_numpy(x) @ q).numpy(),
                               atol=2e-5)
    if kind != "randortho":
        jbe = jtr.get_backend(kind)
        np.testing.assert_allclose(
            fast.numpy(), np.asarray(jbe.apply_fast(jnp.asarray(x),
                                                    jbe.matrix(n))),
            atol=2e-5)


def test_randortho_orthogonal_and_deterministic():
    a = ttr.random_orthogonal_matrix(32)
    assert torch.equal(a, ttr.random_orthogonal_matrix(32))
    assert torch.equal(a, ttr.RandOrthoBackend().matrix(32))
    assert not torch.allclose(a, ttr.random_orthogonal_matrix(32, seed=1))
    np.testing.assert_allclose((a.double().T @ a.double()).numpy(),
                               np.eye(32), atol=5e-6)
    # the canonical representative of G = QR: R = Q^T G has diag >= 0
    g = torch.randn((32, 32), generator=torch.Generator().manual_seed(0))
    assert (torch.diagonal(a.double().T @ g.double()) >= 0).all()


def test_register_backend_refuses_silent_overwrite():
    with pytest.raises(ValueError, match="already registered"):
        ttr.register_backend(ttr.DSTBackend())
    with pytest.raises(ValueError, match="non-empty"):
        ttr.register_backend(ttr.BasisBackend())


def test_registered_backend_reaches_the_projectors(monkeypatch):
    class Stub(ttr.DCTBackend):
        kind = "stub_basis"

    monkeypatch.setattr(ttr, "_REGISTRY", dict(ttr._REGISTRY))
    ttr.register_backend(Stub())
    assert "stub_basis" in projector_kinds()
    Projector(kind="stub_basis", r=2)


def test_basis_cache_serves_all_kinds_and_injected(clean_cache):
    for kind in KINDS:
        a = ttr.shared_basis(kind, 16)
        assert ttr.shared_basis(kind, 16) is a
    assert clean_cache.misses == 4 and clean_cache.hits == 4
    jq = torch.from_numpy(np.array(jtr.random_orthogonal_matrix(24)))
    clean_cache.put("randortho", 24, jq)
    assert ttr.shared_basis("randortho", 24) is jq
    with pytest.raises(ValueError):
        clean_cache.put("randortho", 25, jq)


# ---------------------------------------------------------------------------
# DCT-AdamW with each basis, from a JAX-built state
# ---------------------------------------------------------------------------
R = 6


def _planted(shape, q, seed):
    """G whose S = G @ Q has R planted columns 8x larger than the rest, so
    both frameworks select the same indices."""
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    s = rng.standard_normal(shape)
    scale = np.full((*batch, n), 0.125)
    for b in np.ndindex(*batch):
        scale[b][rng.permutation(n)[:R]] = 1.0
    return ((s * scale[..., None, :]) @ np.asarray(q, np.float64).T
            ).astype(np.float32)


@pytest.mark.parametrize("mode", ["off", "fft", "on"])
@pytest.mark.parametrize("kind", ["dst", "hadamard", "randortho"])
@pytest.mark.parametrize("shape", [(3, 40, 32), (33, 17)],
                         ids=["stacked", "odd"])
def test_dct_adamw_basis_steps_match_jax(shape, kind, mode):
    """Three updates from a JAX-built state (its randortho matrix carried
    in the state's bases): the same indices, the updates at 1e-4."""
    n = min(shape[-2:])
    kw = dict(rank=R, fused=mode, weight_decay=0.1, basis=kind)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, 10), **kw)
    params_np = {"w": {"kernel": _rand(shape, 0)}}
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    key = f"{kind}:{n}"
    assert set(jstate.bases) == {key}
    q = np.asarray(jstate.bases[key])
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    assert np.array_equal(tstate.bases[key].numpy(), q)
    tparams = convert.params_from_jax(params_np, device="cpu")
    for step in range(3):
        g = _planted(shape, q, 30 + step)
        g_np = {"w": {"kernel": g}}
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        jleaf = jstate.leaves[0]["lowrank"]["w"]["kernel"]
        tleaf = tstate.leaves[0]["lowrank"]["w/kernel"]
        np.testing.assert_array_equal(tleaf.proj.numpy(),
                                      np.asarray(jleaf.proj))
        want = np.asarray(ju["w"]["kernel"])
        np.testing.assert_allclose(tu["w/kernel"].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the smoke llama with --basis
# ---------------------------------------------------------------------------
JAX_CFG = jax_llama.SMOKE
CFG = get_config("llama-350m", smoke=True)
# rank 16 on the smoke llama (n = 128), lr 0.01, cosine warmup 2: the
# rank-16 DCT trajectory's tolerance (test_torch_model_train.py); measured
# max relative loss difference over the 10 steps: hadamard 9.4e-5 (fft) and
# 1.6e-4 (on), randortho 1.3e-4 (both)
BASIS_TRAJECTORY_RTOL = 1e-3


@pytest.mark.parametrize("fused", ["fft", "on"])
@pytest.mark.parametrize("kind", ["hadamard", "randortho"])
def test_ten_step_basis_trajectory_matches_jax(kind, fused, clean_cache):
    kw = dict(rank=16, fused=fused, weight_decay=0.01, basis=kind)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, 10), **kw)
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(0))
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    if kind == "randortho":       # the JAX matrix, through the cache
        clean_cache.put(kind, 128, torch.from_numpy(
            np.array(jstate.opt_state.bases[f"{kind}:128"])))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    tstate = TS.TrainState(0, tparams, topt.init(tparams))
    assert np.array_equal(tstate.opt_state.bases[f"{kind}:128"].numpy(),
                          np.asarray(jstate.opt_state.bases[f"{kind}:128"]))
    jstep = jax.jit(JS.make_train_step(JAX_CFG, jopt))
    tstep = TS.make_train_step(CFG, topt)
    data = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4)
    jls, tls = [], []
    for i in range(10):
        b = {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jls.append(float(jm["loss"]))
        tls.append(float(tm["loss"]))
    np.testing.assert_allclose(tls, jls, rtol=BASIS_TRAJECTORY_RTOL)
    assert tls[-1] < tls[0] - 0.5


@pytest.mark.parametrize("kind", ["dst", "hadamard", "randortho"])
def test_cli_basis_runs_on_cpu(monkeypatch, kind, capsys):
    from repro_torch.optim import api
    seen = []
    build = api.get_optimizer
    monkeypatch.setattr(api, "get_optimizer",
                        lambda name, lr, **kw: seen.append(kw) or
                        build(name, lr, **kw))
    assert train_cli.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq-len", "16",
                           "--optimizer", "dct_adamw", "--basis", kind,
                           "--fused", "fft"]) == 0
    assert seen[0]["basis"] == kind
    assert "[train] done at step 2" in capsys.readouterr().out


def test_unknown_basis_is_refused():
    with pytest.raises(ValueError, match="unknown basis"):
        get_optimizer("dct_adamw", lr=0.01, basis="wavelet")
