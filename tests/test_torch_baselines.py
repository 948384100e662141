"""The paper's baselines (LDAdamW, GaLore, FRUGAL, FIRA, AdamW) and the
dense projectors of the port against the JAX package's.

The optimizer cases build a JAX state, take one JAX step, carry the state
across with ``repro_torch.convert`` and take three steps in both packages on
the same numpy gradients, on the four leaf shapes. Gradients have well
separated singular values for the dense projectors (so both frameworks find
the same singular subspace) and the DCT-planted spectrum of
``test_torch_fused_step.planted`` for the ``dct`` projector (so both select
the same columns).

Column signs: ``torch.linalg.svd`` and ``jnp.linalg.svd`` may pick other
signs for a singular vector. The tests hold what the sign cannot change: the
basis up to per-column sign, a refresh from zero moments, every keep step
from a carried JAX basis, and LDAdamW (its rotation carries the moments into
each new basis). Where GaLore refreshes with non-zero moments, the test
hands the port's SVD JAX's column signs, after asserting that the two bases
agree up to them.

``random`` and ``randperm`` draw from the port's own stream; the parity
cases patch the port's two draw functions to return JAX's draws, made with
the JAX package's own ``leaf_key``.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projectors as jproj
from repro.data.synthetic import SyntheticLM
from repro.optim.api import OPTIMIZERS as JAX_OPTIMIZERS
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.optim.transform import leaf_key as jax_leaf_key
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.core import projectors as tproj
from repro_torch.launch import train as train_cli
from repro_torch.optim import api as tapi
from repro_torch.optim import transform as ttf
from repro_torch.optim.api import get_optimizer
from repro_torch.optim.projected_adam import ProjAdamLeaf
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup

from test_torch_fused_step import SHAPES, planted
from test_torch_model_train import CFG, JAX_CFG, _jax_params
from test_torch_optim import R, _close, _flat, _params

# (preset, keywords): every baseline with its default projector, and the
# projectors the presets document (paper Table 6); random and randperm
# refresh every step so their draws are taken
CASES = {
    "ldadamw": ("ldadamw", {}),
    "galore": ("galore", {}),
    "galore-dct-off": ("galore", {"projector": "dct", "fused": "off"}),
    "galore-dct-on": ("galore", {"projector": "dct", "fused": "on"}),
    "frugal": ("frugal", {}),
    "frugal-dct-off": ("frugal", {"projector": "dct", "fused": "off"}),
    "frugal-dct-on": ("frugal", {"projector": "dct", "fused": "on"}),
    "frugal-random": ("frugal", {"projector": "random", "update_interval": 1}),
    "frugal-randperm": ("frugal", {"projector": "randperm",
                                   "update_interval": 1}),
    "fira": ("fira", {}),
    "fira-dct-off": ("fira", {"projector": "dct", "fused": "off"}),
    "fira-dct-on": ("fira", {"projector": "dct", "fused": "on"}),
    "adamw": ("adamw", {}),
}
DENSE = ("svd", "power", "random")
PATHS = ("block/w/kernel", "final_norm/scale")


def spectral(shape, seed):
    """G (oriented, n last) = U diag(s) V^T with s_k = 10 * 0.7^k: every
    gap between neighbouring singular values is 30%, so each singular
    vector (and the top-r subspace) is well defined in fp32. U changes with
    ``seed``; V is the same for every seed, as a gradient's right subspace
    drifts slowly between steps: LDAdamW's one power iteration from the
    previous basis then stays well conditioned (from an unrelated basis it
    amplifies fp32 rounding by the spread of s^2 over the overlap)."""
    rng, rng_v = np.random.default_rng(seed), np.random.default_rng(0)
    *batch, m, n = shape
    out = np.empty((*batch, m, n))
    s = 10.0 * 0.7 ** np.arange(n)
    for b in np.ndindex(*batch):
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        v, _ = np.linalg.qr(rng_v.standard_normal((n, n)))
        out[b] = (u * s) @ v.T
    return out.astype(np.float32)


def _projector_of(name, kw):
    return kw.get("projector", {"ldadamw": "power", "adamw": None}.get(
        name, "svd"))


def _grads(shape, seed, projector):
    """Gradients in the parameter's layout, planted in the oriented one."""
    m, n = shape[-2:]
    make = planted if projector == "dct" else spectral
    if n <= m:
        g = make(shape, seed)
    else:
        g = np.swapaxes(make((*shape[:-2], n, m), seed), -1, -2).copy()
    norm = np.random.default_rng(seed + 100).standard_normal(shape[-1:])
    return {"block": {"w": {"kernel": g}},
            "final_norm": {"scale": norm.astype(np.float32)}}


def _np(x):
    return torch.from_numpy(np.array(x))


def _hand_jax_draws(monkeypatch, steps, seed=0, paths=PATHS):
    """Patch the port's two draw functions to return the JAX package's
    draws for the same (seed, step, leaf path): ``jax.random`` keys made
    with JAX's ``leaf_key``, looked up by the port's key."""
    table = {}
    for t in steps:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        tkey = ttf.fold_in(seed, t)
        for p in paths:
            table[ttf.leaf_key(tkey, p)] = jax_leaf_key(jkey, p)
    monkeypatch.setattr(tproj, "gaussian_draw", lambda key, shape, device: _np(
        jax.random.normal(table[key], shape, jnp.float32)).to(device))
    monkeypatch.setattr(tproj, "permutation_draw", lambda key, n, device: _np(
        jax.random.permutation(table[key], n)).to(device))


def _same_up_to_sign(qt, qj, tol=1e-4):
    """Each column of ``qt`` is the same column of ``qj`` or its negative;
    returns the signs."""
    sign = np.sign(np.sum(qt * qj, axis=-2, keepdims=True))
    np.testing.assert_allclose(qt * sign, qj, atol=tol, rtol=0)
    return sign


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_baseline_steps_match_jax(monkeypatch, case, shape_name):
    name, kw = CASES[case]
    shape = SHAPES[shape_name]
    projector = _projector_of(name, kw)
    params_np = _params(shape)
    kw = dict(kw, weight_decay=0.1)
    if name != "adamw":
        kw["rank"] = R
    jopt = jax_get_optimizer(name, lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer(name, lr=cosine_warmup(0.01, 2, 10), **kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    # one JAX step first: non-zero moments, a refreshed basis, inner_step 1
    _, jstate = jopt.update(
        jax.tree.map(jnp.asarray, _grads(shape, 10, projector)), jstate,
        jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tparams = convert.params_from_jax(params_np, device="cpu")
    assert tstate.step == 1 and tstate.seed == 0
    _hand_jax_draws(monkeypatch, steps=(2, 3, 4))
    for step in range(3):
        g_np = _grads(shape, 20 + step, projector)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        ju_flat = _flat(jax.tree.map(np.asarray, ju))
        assert set(tu) == set(ju_flat)
        for path, u in tu.items():
            _close(u.numpy(), ju_flat[path], f"{case} {path} step {step}")
    if name == "adamw":
        jm = jstate.leaves[0]["block"]["w"]["kernel"].mom
        _close(tstate.leaves[0]["block/w/kernel"].mom.m.numpy(),
               np.asarray(jm.m))
        return
    jleaf = jstate.leaves[0]["lowrank"]["block"]["w"]["kernel"]
    tleaf = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    assert isinstance(tleaf, ProjAdamLeaf)
    assert tleaf.inner_step == int(jleaf.inner_step) == 4
    if projector in DENSE:
        assert tleaf.proj.dtype == torch.float32
        _same_up_to_sign(tleaf.proj.numpy(), np.asarray(jleaf.proj))
    else:
        assert tleaf.proj.dtype == torch.int32
        np.testing.assert_array_equal(tleaf.proj.numpy(),
                                      np.asarray(jleaf.proj))
    if name == "ldadamw":          # the fp32 error-feedback buffer
        assert tleaf.ef.dtype == torch.float32
        _close(tleaf.ef.numpy(), np.asarray(jleaf.ef))
    else:
        assert tleaf.ef is None and jleaf.ef is None


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_galore_refresh_and_keep_steps_match_jax(monkeypatch, shape_name):
    """GaLore with T_u 3 over 5 steps from a JAX-built init: step 1
    refreshes from zero moments, steps 2-3 keep, step 4 refreshes with
    non-zero moments (the port's SVD handed JAX's column signs, after the
    bases are held equal up to them), step 5 keeps."""
    shape = SHAPES[shape_name]
    params_np = _params(shape)
    kw = dict(rank=R, update_interval=3)
    jopt = jax_get_optimizer("galore", lr=0.01, **kw)
    topt = get_optimizer("galore", lr=0.01, **kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tparams = convert.params_from_jax(params_np, device="cpu")
    svd = torch.linalg.svd
    flips = []

    def svd_with_jax_signs(a, full_matrices=True):
        u, s, vh = svd(a, full_matrices=full_matrices)
        _, _, vj = jnp.linalg.svd(jnp.asarray(a.numpy()),
                                  full_matrices=full_matrices)
        k = min(R, vh.shape[-2])
        sign = _same_up_to_sign(vh[..., :k, :].mT.numpy(),
                                np.swapaxes(np.asarray(vj)[..., :k, :], -1, -2))
        flips.append(int((sign < 0).sum()))
        sign = torch.from_numpy(np.swapaxes(sign, -1, -2))
        vh = torch.cat([vh[..., :k, :] * sign, vh[..., k:, :]], dim=-2)
        return u, s, vh

    monkeypatch.setattr(torch.linalg, "svd", svd_with_jax_signs)
    for step in range(5):
        g_np = _grads(shape, 30 + step, "svd")
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        _close(tu["block/w/kernel"].numpy(),
               np.asarray(ju["block"]["w"]["kernel"]), f"step {step}")
    assert len(flips) == 2          # the two refreshes, steps 1 and 4


@pytest.mark.parametrize("shape_name", ["2d", "stacked"])
@pytest.mark.parametrize("name", ["galore", "frugal", "fira"])
def test_svd_refresh_from_zero_moments_matches_jax(name, shape_name):
    """The port's own SVD (whatever its column signs) at a refresh from
    zero moments: the update does not depend on the signs."""
    shape = SHAPES[shape_name]
    params_np = _params(shape)
    jopt = jax_get_optimizer(name, lr=0.01, rank=R)
    topt = get_optimizer(name, lr=0.01, rank=R)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    g_np = _grads(shape, 40, "svd")
    ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate, jparams)
    tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                             tstate,
                             convert.params_from_jax(params_np, device="cpu"))
    _close(tu["block/w/kernel"].numpy(), np.asarray(ju["block"]["w"]["kernel"]))
    _same_up_to_sign(tstate.leaves[0]["lowrank"]["block/w/kernel"].proj.numpy(),
                     np.asarray(jstate.leaves[0]["lowrank"]["block"]["w"]
                                ["kernel"].proj))


# ---------------------------------------------------------------------------
# the projectors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("kind", jproj.DENSE_KINDS)
def test_dense_projector_matches_jax(monkeypatch, kind, shape_name):
    shape = SHAPES[shape_name]
    n = shape[-1]
    jp, tp = jproj.Projector(kind=kind, r=R), tproj.Projector(kind=kind, r=R)
    assert (tp.index_based, tp.needs_shared_basis, tp.needs_key) == \
        (jp.index_based, jp.needs_shared_basis, jp.needs_key)
    j0, t0 = jp.init(shape), tp.init(shape)
    assert t0.dtype == {"randperm": torch.int32}.get(kind, torch.float32)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    # a previous basis that is not the identity (power warm-starts from it)
    prev = spectral((*shape[:-2], n, R), 1)
    if kind in DENSE:
        prev = np.linalg.qr(prev)[0].astype(np.float32)
        j0, t0 = jnp.asarray(prev), torch.from_numpy(prev)
    g = spectral(shape, 2)
    jkey = jax.random.PRNGKey(7)
    monkeypatch.setattr(tproj, "gaussian_draw", lambda key, shp, device: _np(
        jax.random.normal(jkey, shp, jnp.float32)))
    monkeypatch.setattr(tproj, "permutation_draw", lambda key, m, device: _np(
        jax.random.permutation(jkey, m)))
    j1 = jp.update(jnp.asarray(g), j0, key=jkey)
    t1 = tp.update(torch.from_numpy(g), t0, key=12345)
    if kind == "svd":
        _same_up_to_sign(t1.numpy(), np.asarray(j1))
    elif kind == "randperm":
        assert t1.dtype == torch.int32
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    else:       # QR by Householder in both: the same column signs
        np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-5)
    # project / backproject / basis_matrix / rotation on JAX's state
    tj1 = _np(j1)
    jlow = jp.project(jnp.asarray(g), j1)
    tlow = tp.project(torch.from_numpy(g), tj1)
    np.testing.assert_allclose(tlow.numpy(), np.asarray(jlow), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jlow)).max())
    np.testing.assert_allclose(
        tp.backproject(tlow, tj1, n=n).numpy(),
        np.asarray(jp.backproject(jlow, j1, n=n)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tp.basis_matrix(tj1, n).numpy(),
                                  np.asarray(jp.basis_matrix(j1, n)))
    for exact in (False, True):
        np.testing.assert_allclose(
            tproj.rotation_matrix(_np(j0), tj1, tp, n,
                                  exact_matmul=exact).numpy(),
            np.asarray(jproj.rotation_matrix(j0, j1, jp, n,
                                             exact_matmul=exact)),
            atol=1e-5)


def test_projector_names_match_jax():
    assert tproj.DENSE_KINDS == jproj.DENSE_KINDS
    assert tproj.projector_kinds() == jproj.projector_kinds()
    assert tproj.PROJECTOR_KINDS == jproj.PROJECTOR_KINDS
    for kind in jproj.projector_kinds():
        tproj.Projector(kind=kind, r=4)
        jq, tq = jproj.shared_basis_for(kind, 16), tproj.shared_basis_for(kind, 16)
        if jq is None:
            assert tq is None and kind in tproj.DENSE_KINDS
        elif kind != "randortho":        # randortho: another stream
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    with pytest.raises(ValueError, match="unknown projector kind"):
        tproj.Projector(kind="qr", r=4)


@pytest.mark.parametrize("name,kw", [("ldadamw", {}), ("galore", {}),
                                     ("frugal", {"projector": "randperm"}),
                                     ("fira", {"projector": "random"})])
def test_dense_presets_store_no_basis(name, kw):
    """The dense kinds keep their basis per leaf: no shared (n, n) basis is
    stored (the paper's memory comparison rests on it)."""
    params_np = _params(SHAPES["stacked"])
    jstate = jax_get_optimizer(name, lr=0.01, rank=R, **kw).init(
        jax.tree.map(jnp.asarray, params_np))
    tstate = get_optimizer(name, lr=0.01, rank=R, **kw).init(
        convert.params_from_jax(params_np, device="cpu"))
    assert jstate.bases == {} and tstate.bases == {} and tstate.bases_t == {}
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    a = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    b = conv.leaves[0]["lowrank"]["block/w/kernel"]
    for x, y in [(a.m, b.m), (a.v, b.v), (a.proj, b.proj)]:
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
    assert (a.ef is None) == (b.ef is None)


def test_adamw_and_seed_carry_across():
    params_np = _params(SHAPES["odd"])
    jopt = jax_get_optimizer("adamw", lr=0.01)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params_np))
    tstate = get_optimizer("adamw", lr=0.01).init(
        convert.params_from_jax(params_np, device="cpu"))
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    assert set(conv.leaves[0]) == set(tstate.leaves[0]) == set(PATHS)
    assert conv.bases == tstate.bases == {}
    big = jax.tree.map(np.asarray, jax_get_optimizer(
        "galore", lr=0.01, rank=R).init(jax.tree.map(jnp.asarray, params_np)))
    big = big._replace(key=np.asarray(jax.random.PRNGKey(7)))
    assert convert.opt_state_from_jax(big, device="cpu").seed == 7
    # threefry's uint32 pair, high word first
    big = big._replace(key=np.array([1, 5], np.uint32))
    assert convert.opt_state_from_jax(big, device="cpu").seed == 2**32 + 5


# ---------------------------------------------------------------------------
# the port's own stream
# ---------------------------------------------------------------------------
def test_port_stream_repeats_and_differs():
    assert ttf.path_hash("block/0/wq") == zlib.crc32(b"block/0/wq") & 0x7FFFFFFF
    keys = {(s, t, p): ttf.leaf_key(ttf.fold_in(s, t), p)
            for s in (0, 1) for t in (1, 2, 3) for p in PATHS}
    assert len(set(keys.values())) == len(keys)
    assert all(0 <= k < 2**63 for k in keys.values())
    assert ttf.leaf_key(None, "a") is None
    for kind in ("random", "randperm"):
        p = tproj.Projector(kind=kind, r=5)
        g = torch.zeros(3, 20, 12)
        a = p.update(g, p.init(g.shape), key=keys[(0, 1, PATHS[0])])
        b = p.update(g, p.init(g.shape), key=keys[(0, 1, PATHS[0])])
        c = p.update(g, p.init(g.shape), key=keys[(0, 2, PATHS[0])])
        d = p.update(g, p.init(g.shape), key=keys[(0, 1, PATHS[1])])
        assert torch.equal(a, b)
        assert not torch.equal(a, c) and not torch.equal(a, d)
        if kind == "random":
            assert a.shape == (3, 12, 5)
            eye = torch.eye(5).expand(3, 5, 5)
            torch.testing.assert_close(a.mT @ a, eye, atol=1e-5, rtol=0)
            assert not torch.equal(a[0], a[1])      # one draw per layer
        else:
            assert a.shape == (3, 5) and a.dtype == torch.int32
            assert torch.equal(a[0], a[1])          # shared by the layers
            assert (a[0, 1:] > a[0, :-1]).all() and 0 <= a.min() <= a.max() < 12
    with pytest.raises(ValueError, match="per-leaf key"):
        tproj.Projector(kind="random", r=2).update(torch.zeros(4, 3),
                                                  torch.eye(3, 2))


def test_optimizer_draws_differ_per_step_and_leaf():
    """FRUGAL with a random projector through the runtime: each step and
    each leaf of a stacked model draws a new basis, and the same seed
    repeats the run."""
    params = {"a/kernel": torch.zeros(2, 16, 8), "b/kernel": torch.zeros(16, 8)}
    grads = {k: torch.ones_like(v) for k, v in params.items()}

    def run(seed):
        opt = get_optimizer("frugal", lr=0.01, rank=3, projector="random",
                            update_interval=1)
        state = opt.init(params)._replace(seed=seed)
        out = []
        for _ in range(2):
            _, state = opt.update(grads, state, params)
            out.append({k: v.proj.clone() for k, v in
                        state.leaves[0]["lowrank"].items()})
        return out

    a, b, c = run(0), run(0), run(1)
    for s in range(2):
        for k in params:
            assert torch.equal(a[s][k], b[s][k])
            assert not torch.equal(a[s][k], c[s][k])
    assert not torch.equal(a[0]["a/kernel"], a[1]["a/kernel"])
    assert not torch.equal(a[0]["a/kernel"][0], a[0]["b/kernel"])


def test_overrides_reach_each_leaf():
    params_np = _params(SHAPES["stacked"])
    over = {"block/w/kernel": {"rank": 3}}
    jstate = jax_get_optimizer("galore", lr=0.01, rank=R, overrides=over
                               ).init(jax.tree.map(jnp.asarray, params_np))
    tstate = get_optimizer("galore", lr=0.01, rank=R, overrides=over).init(
        convert.params_from_jax(params_np, device="cpu"))
    leaf = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    jleaf = jstate.leaves[0]["lowrank"]["block"]["w"]["kernel"]
    assert leaf.proj.shape == jleaf.proj.shape == (3, 24, 3)
    assert get_optimizer("dct_adamw", lr=0.01, rank=R, overrides=over).init(
        convert.params_from_jax(params_np, device="cpu")).leaves[0]["lowrank"][
            "block/w/kernel"].proj.shape == (3, 3)


def test_dense_projector_refuses_low_precision():
    """compute_dtype is dct_adamw's; on the rule a dense projector refuses
    a non-fp32 one with the reference's message."""
    from repro_torch.optim.common import Context
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    rule = ProjectedAdamRule(projector="svd", rank=2, fused="on",
                             compute_dtype="int8", residual="discard",
                             needs_shared_basis=False)
    g = torch.ones(8, 4)
    with pytest.raises(ValueError, match="needs the fused dataflow"):
        rule.update(g, rule.init(g.shape, g.dtype), g,
                    Context(step=1, bases={}))
    assert not rule.zero_shardable
    assert ProjectedAdamRule(projector="randperm").zero_shardable
    assert not ProjectedAdamRule(projector="dct", residual="fira").zero_shardable


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
# 10-step loss trajectories of the optimizers the CLI builds, llama smoke
# (d 128), rank 16, lr 0.01 with cosine warmup 2, on SyntheticLM's batches.
# The frameworks sum in fp32 in other orders; the low-rank baselines then
# amplify the difference: a top-16 cut among close singular values (galore,
# fira) or DCT column norms (frugal --basis dct), one power iteration from
# the previous basis (ldadamw), and FRUGAL's sign of near-zero residual
# entries, which moves an update entry by 2 lr. Every step-2 loss agrees to
# 4e-7. Measured max relative gaps over the 10 steps: ldadamw 2.2e-4, galore
# 7.7e-5, frugal --basis dct 3.2e-3, fira 1.9e-4, adamw 3.0e-6; held at
# about 3-6x that. (At the CLI's default rank 128 = n the gaps reach 6e-3:
# every singular vector, however close its neighbours, is then a basis
# column.)
CLI_RTOL = {"ldadamw": 1e-3, "galore": 5e-4, "frugal": 1e-2, "fira": 1e-3,
            "adamw": 1e-5}
_CLI = ["--smoke", "--device", "cpu", "--batch", "2", "--seq-len", "16"]


def _cli_optimizer(monkeypatch, argv):
    """The (name, keywords) the port's CLI builds for ``argv``."""
    seen = []
    build = tapi.get_optimizer
    monkeypatch.setattr(tapi, "get_optimizer",
                        lambda name, lr, **kw: seen.append((name, kw)) or
                        build(name, lr, **kw))
    assert train_cli.main([*_CLI, "--steps", "1", *argv]) == 0
    return seen[0]


@pytest.mark.parametrize("argv", [
    ["--optimizer", "ldadamw", "--rank", "16"],
    ["--optimizer", "galore", "--rank", "16"],
    ["--optimizer", "frugal", "--basis", "dct", "--rank", "16"],
    ["--optimizer", "fira", "--rank", "16"],
    ["--optimizer", "adamw"],
])
def test_cli_ten_step_loss_trajectory_matches_jax(monkeypatch, argv):
    name, kw = _cli_optimizer(monkeypatch, argv)
    assert name == argv[1]
    assert ("rank" in kw) == (name != "adamw")
    assert kw.get("projector") == ("dct" if "--basis" in argv else None)
    jopt = jax_get_optimizer(name, lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer(name, lr=cosine_warmup(0.01, 2, 10), **kw)
    jparams = _jax_params()
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    tstate = TS.TrainState(0, tparams, topt.init(tparams))
    jstep = jax.jit(JS.make_train_step(JAX_CFG, jopt))
    tstep = TS.make_train_step(CFG, topt)
    data = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4)
    jl, tl = [], []
    for i in range(10):
        b = {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=CLI_RTOL[name])
    assert tl[-1] < tl[0] - 1.0


@pytest.mark.parametrize("argv,match", [
    (["--optimizer", "ldadamw", "--basis", "dct"],
     "--basis applies to dct_adamw/galore/frugal/fira, not 'ldadamw'"),
    (["--optimizer", "adamw", "--fused", "on"],
     "--fused applies to dct_adamw/ldadamw/galore/frugal/fira/muon/trion/"
     "dion, not 'adamw'"),
    (["--optimizer", "galore", "--compute-dtype", "int8"],
     "--compute-dtype applies to dct_adamw, not 'galore'"),
])
def test_cli_baseline_refusals(argv, match):
    with pytest.raises(SystemExit) as e:
        train_cli.main([*_CLI, "--steps", "1", *argv])
    assert str(e.value) == match


@pytest.mark.parametrize("argv,want", [
    (["--optimizer", "adamw"], ("adamw", {"weight_decay": 0.01})),
    (["--optimizer", "fira", "--basis", "hadamard", "--fused", "off"],
     ("fira", {"weight_decay": 0.01, "rank": 128, "fused": "off",
               "projector": "hadamard"})),
    (["--optimizer", "ldadamw"],
     ("ldadamw", {"weight_decay": 0.01, "rank": 128})),
])
def test_cli_builds_the_baselines(monkeypatch, argv, want):
    assert _cli_optimizer(monkeypatch, argv) == want
    assert train_cli.PROJECTED_ADAM_FAMILY == ("dct_adamw", "ldadamw",
                                               "galore", "frugal", "fira")
    assert set(tapi.OPTIMIZERS) == set(JAX_OPTIMIZERS)
    assert "adamw" in tapi.TRANSFORMS
