"""The momentum families of the port — Trion, Muon (full space and subspace)
and Dion — against the JAX package's presets, and the invariants of
``tests/test_subspace_fusion.py`` in the port.

A state built by JAX (init and one update) is carried across by
``repro_torch.convert``; then three updates on the same numpy gradients in
both, for fused modes "off" and "on" (Trion also "fft" and
``dct_method="fft"``). The port's "on" runs the kernels' plain versions on
CPU tensors, the JAX package's the Pallas kernels in interpret mode. The
gradients have a planted spectrum on a fixed set of DCT columns, so every
top-r cut has a clear margin and the selected indices must be equal; a spy
on ``select_top_r`` in both packages checks that, and on a difference
reports the margin at the cut.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused_step as jfs
from repro.core import selection as jsel
from repro.core.dct import dct2_matrix as jax_dct2
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro_torch import convert
from repro_torch.core import fused_step
from repro_torch.core import selection as tsel
from repro_torch.core.newton_schulz import newton_schulz
from repro_torch.kernels import ops
from repro_torch.optim.api import get_optimizer, get_transform
from repro_torch.optim.common import Context
from repro_torch.optim.dion import DionLeaf
from repro_torch.optim.muon import MuonLeaf
from repro_torch.optim.trion import TrionLeaf
from test_torch_optim import lr_scale_cut_matches_jax

R = 6
# parameter layouts: square-ish, layer-stacked, odd, and wide (orients by a
# transpose)
SHAPES = {"2d": (40, 24), "stacked": (3, 40, 24), "odd": (33, 17),
          "wide": (16, 48)}
# (preset, kwargs, fused mode)
CASES = {
    "trion-off": ("trion", {"rank": R}, "off"),
    "trion-on": ("trion", {"rank": R}, "on"),
    "trion-fft": ("trion", {"rank": R}, "fft"),
    "trion-off-dctfft": ("trion", {"rank": R, "dct_method": "fft"}, "off"),
    "muon-off": ("muon", {}, "off"),
    "muon-on": ("muon", {}, "on"),
    "muon_rank-off": ("muon", {"rank": R}, "off"),
    "muon_rank-on": ("muon", {"rank": R}, "on"),
    "dion-off": ("dion", {"rank": R}, "off"),
    "dion-on": ("dion", {"rank": R}, "on"),
}
# the modules (the packages export functions of the same names)
jmuon = importlib.import_module("repro.optim.muon")
tmuon = importlib.import_module("repro_torch.optim.muon")
LEAF = {"trion": TrionLeaf, "muon": MuonLeaf, "dion": DionLeaf}
# Updates and states within 1e-5 of their largest entry: fp32 sums in other
# orders in S, the Newton-Schulz products (whose quintic amplifies relative
# differences in small singular directions) and the back-projections,
# carried over three updates; measured <= 2.5e-6 over CASES x SHAPES.
RTOL = 1e-5


def _planted(shape, seed):
    """Oriented G whose S = G @ Q has R planted columns, the same ones for
    every seed, 8x larger than the rest."""
    rng = np.random.default_rng(seed)
    *batch, m, n = shape
    s = rng.standard_normal(shape)
    cols = np.random.default_rng(99)
    scale = np.full((*batch, n), 0.125)
    for b in np.ndindex(*batch):
        scale[b][cols.permutation(n)[:R]] = 1.0
    q = np.asarray(jax_dct2(n), np.float64)
    return ((s * scale[..., None, :]) @ q.T).astype(np.float32)


def _params(shape):
    rng = np.random.default_rng(0)
    return {"block": {"w": {"kernel": rng.standard_normal(shape).astype(np.float32)}},
            "final_norm": {"scale": rng.standard_normal(shape[-1:]).astype(np.float32)}}


def _grads(shape, seed):
    m, n = shape[-2:]
    if n <= m:
        g = _planted(shape, seed)
    else:
        g = np.swapaxes(_planted((*shape[:-2], n, m), seed), -1, -2).copy()
    norm = np.random.default_rng(seed + 100).standard_normal(shape[-1:])
    return {"block": {"w": {"kernel": g}},
            "final_norm": {"scale": norm.astype(np.float32)}}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


def _spy_selection(monkeypatch):
    """Record (norms, idx) of every top-r selection in both packages."""
    seen = {"jax": [], "torch": []}

    def spy(orig, key):
        def f(norms, r, *a, **kw):
            idx = orig(norms, r, *a, **kw)
            seen[key].append((np.asarray(norms), np.asarray(idx)))
            return idx
        return f

    jorig, torig = jsel.select_top_r, tsel.select_top_r
    for mod in (jsel, jfs, jmuon):
        monkeypatch.setattr(mod, "select_top_r", spy(jorig, "jax"))
    for mod in (tsel, fused_step, tmuon):
        monkeypatch.setattr(mod, "select_top_r", spy(torig, "torch"))
    return seen


def _margin(norms, r):
    v = -np.sort(-norms, axis=-1)
    return (v[..., r - 1] - v[..., r]) / v[..., :1][..., 0]


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_jax(monkeypatch, case, name):
    preset, kw, mode = CASES[case]
    shape = SHAPES[name]
    kw = dict(kw, fused=mode, weight_decay=0.1)
    jopt = jax_get_optimizer(preset, lr=0.01, **kw)
    topt = get_optimizer(preset, lr=0.01, **kw)
    params_np = _params(shape)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    # one JAX update first, so the carried state holds a momentum (and
    # Dion's projection) that is not the initial one
    _, jstate = jopt.update(jax.tree.map(jnp.asarray, _grads(shape, 10)),
                            jstate, jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tparams = convert.params_from_jax(params_np, device="cpu")
    seen = _spy_selection(monkeypatch)
    for step in range(3):
        g_np = _grads(shape, 20 + step)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        _close(tu["block/w/kernel"].numpy(),
               np.asarray(ju["block"]["w"]["kernel"]), f"update {step}")
        # the full-rank Adam leaf at test_torch_optim.py's tolerance: its
        # sqrt and division put an element ~1e-5 apart now and then
        want = np.asarray(ju["final_norm"]["scale"])
        np.testing.assert_allclose(tu["final_norm/scale"].numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"adam {step}")
    assert len(seen["jax"]) == len(seen["torch"])
    for (jn, ji), (tn, ti) in zip(seen["jax"], seen["torch"]):
        assert np.array_equal(ti, ji), \
            f"selection differs; margin at the cut {_margin(jn, R)}"
    if preset == "trion" or (preset == "muon" and "rank" in kw):
        assert len(seen["torch"]) == 3
    jleaf = jstate.leaves[0]["lowrank"]["block"]["w"]["kernel"]
    tleaf = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    assert type(tleaf) is LEAF[preset]
    _close(tleaf.m.numpy(), np.asarray(jleaf.m), "momentum")
    if preset == "dion":
        # Q_t is defined up to column signs (a QR's, or the NS factor's
        # through R_t = B^T P_t); M_t and O_t are not
        jq = np.asarray(jleaf.q)
        signs = np.sign(np.sum(tleaf.q.numpy() * jq, axis=-2, keepdims=True))
        _close(tleaf.q.numpy() * signs, jq, "projection up to signs")


def test_dion_qr_column_signs_do_not_reach_the_update(monkeypatch):
    """A QR whose Q has other column signs (as cuSOLVER's, LAPACK's and
    XLA's may) flips the signs of q_t and leaves M_t and O_t as they are."""
    shape = (3, 40, 24)
    opt = get_optimizer("dion", lr=0.01, rank=R, fused="off")
    params = convert.params_from_jax(_params(shape), device="cpu")
    state = opt.init(params)
    _, state = opt.update(convert.params_from_jax(_grads(shape, 1),
                                                  device="cpu"), state,
                          params)
    g = convert.params_from_jax(_grads(shape, 2), device="cpu")
    u, s = opt.update(g, state, params)
    flip = torch.tensor([(-1.0) ** k for k in range(R)])
    qr = torch.linalg.qr

    def flipped_qr(z):
        q, r = qr(z)
        return q * flip, r * flip[:, None]

    monkeypatch.setattr(torch.linalg, "qr", flipped_qr)
    uf, sf = opt.update(g, state, params)
    a = s.leaves[0]["lowrank"]["block/w/kernel"]
    b = sf.leaves[0]["lowrank"]["block/w/kernel"]
    # the same products of sign-flipped factors, rounded alike
    torch.testing.assert_close(uf["block/w/kernel"], u["block/w/kernel"],
                               rtol=0, atol=0)
    torch.testing.assert_close(b.m, a.m, rtol=0, atol=0)
    torch.testing.assert_close(b.q, a.q * flip, rtol=0, atol=0)


@pytest.mark.parametrize("preset,kw", [("trion", {"rank": R}),
                                       ("muon", {}), ("dion", {"rank": R})])
def test_init_state_layout_matches_jax(preset, kw):
    shape = SHAPES["wide"]
    params_np = _params(shape)
    jstate = jax_get_optimizer(preset, lr=0.01, **kw).init(
        jax.tree.map(jnp.asarray, params_np))
    tstate = get_optimizer(preset, lr=0.01, **kw).init(
        convert.params_from_jax(params_np, device="cpu"))
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    assert tstate.bases.keys() == conv.bases.keys()
    a = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    b = conv.leaves[0]["lowrank"]["block/w/kernel"]
    assert type(a) is type(b) is LEAF[preset]
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_bf16_trion_momentum_carries_across():
    shape = SHAPES["stacked"]
    params_np = _params(shape)
    kw = dict(rank=R, momentum_dtype="bfloat16", fused="off")
    jopt = jax_get_optimizer("trion", lr=0.01, **kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    _, jstate = jopt.update(jax.tree.map(jnp.asarray, _grads(shape, 10)),
                            jopt.init(jparams), jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    m = tstate.leaves[0]["lowrank"]["block/w/kernel"].m
    assert m.dtype == torch.bfloat16
    jm = jstate.leaves[0]["lowrank"]["block"]["w"]["kernel"].m
    np.testing.assert_array_equal(m.float().numpy(),
                                  np.asarray(jm, np.float32))


# ---------------------------------------------------------------------------
# tests/test_subspace_fusion.py's invariants, in the port
# ---------------------------------------------------------------------------
L, M, N = 3, 24, 40


def _fusion_params():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy((rng.standard_normal((L, M, N)) * 0.3
                                   ).astype(np.float32)),
            "odd": torch.from_numpy((rng.standard_normal((33, 20)) * 0.3
                                     ).astype(np.float32))}


def _fusion_grads(t, params):
    r = np.random.default_rng(50 + t)
    return {k: torch.from_numpy((r.standard_normal(tuple(v.shape)) * 0.05
                                 ).astype(np.float32))
            for k, v in params.items()}


def _run(opt, params, steps=3):
    st = opt.init(params)
    for t in range(steps):
        u, st = opt.update(_fusion_grads(t, params), st, params)
    return u


@pytest.mark.parametrize("fused", ["off", "on"])
def test_muon_fullrank_subspace_matches_fullspace(fused):
    """NS(XQ) = NS(X)Q through the whole chain (measured ~1e-8 in the
    reference; 1e-6 as there)."""
    params = _fusion_params()
    uf = _run(get_optimizer("muon", lr=1e-2, fused=fused), params)
    us = _run(get_optimizer("muon", lr=1e-2, rank=max(M, N), fused=fused),
              params)
    for k in params:
        torch.testing.assert_close(us[k], uf[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_trion_fullrank_matches_heavyball_muon(fused):
    """B_t = mu*B_{t-1} + G_t is muon's nesterov=False momentum, and at full
    rank the EF reconstruction is exact, so the updates coincide."""
    params = _fusion_params()
    um = _run(get_optimizer("muon", lr=1e-2, nesterov=False, fused=fused),
              params)
    ut = _run(get_optimizer("trion", lr=1e-2, rank=max(M, N), fused=fused),
              params)
    for k in params:
        torch.testing.assert_close(ut[k], um[k], rtol=0, atol=1e-6)


def _spy(monkeypatch):
    calls = {"select": 0, "ns": 0, "ns_shapes": []}
    orig_sel = fused_step.select_and_project
    orig_ns = fused_step.ops.newton_schulz_kernel

    def sel_spy(*a, **kw):
        calls["select"] += 1
        return orig_sel(*a, **kw)

    def ns_spy(x, **kw):
        calls["ns"] += 1
        calls["ns_shapes"].append(tuple(x.shape))
        return orig_ns(x, **kw)

    monkeypatch.setattr(fused_step, "select_and_project", sel_spy)
    monkeypatch.setattr(fused_step.ops, "newton_schulz_kernel", ns_spy)
    return calls


@pytest.mark.parametrize("name", ["muon", "trion", "dion"])
def test_fused_kernels_reached_through_partition(monkeypatch, name):
    """With fused="on" every family reaches the Newton–Schulz kernel path
    (and muon/trion the one-pass select+project) through partition."""
    calls = _spy(monkeypatch)
    params = _fusion_params()
    opt = get_optimizer(name, lr=1e-2, fused="on", rank=8)
    upd, _ = opt.update(_fusion_grads(0, params), opt.init(params), params)
    if name != "dion":
        assert calls["select"] > 0, f"{name}: select+project not reached"
    assert calls["ns"] > 0, f"{name}: Newton-Schulz kernel path not reached"
    for k in params:
        assert torch.isfinite(upd[k]).all()


@pytest.mark.parametrize("name", ["muon", "trion", "dion"])
def test_ns_runs_on_rank_sized_blocks(monkeypatch, name):
    r = 8
    calls = _spy(monkeypatch)
    params = _fusion_params()
    opt = get_optimizer(name, lr=1e-2, rank=r, fused="on")
    opt.update(_fusion_grads(0, params), opt.init(params), params)
    assert calls["ns_shapes"], f"{name}: no NS calls recorded"
    for shape in calls["ns_shapes"]:
        assert min(shape[-2:]) == r, f"{name}: NS ran on {shape}"


def test_ns_envelope_gate_takes_the_plain_iteration(monkeypatch):
    """fused="on" never sends a factor whose short side exceeds
    NS_KERNEL_MAX_RANK to the kernel path: past it the plain iteration
    runs (bit-identical to core newton_schulz)."""
    def boom(x, **kw):
        raise AssertionError(f"NS kernel path dispatched on {x.shape}")

    monkeypatch.setattr(fused_step.ops, "newton_schulz_kernel", boom)
    k = fused_step.NS_KERNEL_MAX_RANK
    big = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (k + 1, k + 8)) * 0.1).astype(np.float32))
    out = fused_step.fused_newton_schulz(big, steps=3, mode="on")
    assert torch.equal(out, newton_schulz(big, steps=3))


def test_fullspace_muon_big_leaf_avoids_kernel_path(monkeypatch):
    def boom(x, **kw):
        raise AssertionError(f"NS kernel path dispatched on {x.shape}")

    monkeypatch.setattr(fused_step.ops, "newton_schulz_kernel", boom)
    k = fused_step.NS_KERNEL_MAX_RANK
    params = {"big": torch.from_numpy((np.random.default_rng(8).standard_normal(
        (k + 4, 560)) * 0.1).astype(np.float32))}
    opt = get_optimizer("muon", lr=1e-2, fused="on")
    upd, _ = opt.update(_fusion_grads(0, params), opt.init(params), params)
    assert torch.isfinite(upd["big"]).all()


def test_dion_ns_steps_passthrough(monkeypatch):
    seen = []
    orig = fused_step.fused_newton_schulz

    def ns_spy(b, *, steps, **kw):
        seen.append(steps)
        return orig(b, steps=steps, **kw)

    monkeypatch.setattr(fused_step, "fused_newton_schulz", ns_spy)
    params = _fusion_params()
    opt = get_optimizer("dion", lr=1e-2, rank=8, ns_steps=3, fused="on")
    opt.update(_fusion_grads(0, params), opt.init(params), params)
    assert seen and set(seen) == {3}, seen
    seen.clear()
    tr = get_transform("dion", lr=1e-2, rank=8, ns_steps=2, fused="on")
    tr.update(_fusion_grads(0, params), tr.init(params), params,
              Context(step=1, bases={}))
    assert seen and set(seen) == {2}, seen


def test_cpu_tensors_launch_nothing():
    params = _fusion_params()
    before = ops.launch_counts()
    for name in ("trion", "muon", "dion"):
        _run(get_optimizer(name, lr=1e-2, rank=8, fused="on"), params, 1)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("name", ["trion", "muon", "dion"])
def test_unported_options_raise(name):
    """ZeRO-1 stays unported; ``lr_scale=True`` is ported and matches JAX
    under a cut of 0.5."""
    with pytest.raises(NotImplementedError):
        get_optimizer(name, lr=0.01, zero=("data",))
    lr_scale_cut_matches_jax(name, rank=8)
    with pytest.raises(ValueError):
        get_optimizer(name, lr=0.01, fused="sometimes")
