"""DCT-AdamW of the port against the JAX package's: a state built by JAX,
carried across by ``repro_torch.convert``, then three update steps on the
same numpy gradients in both, for fused modes off / fft / on on the four
leaf shapes. Gradients have a planted spectrum, so the top-r cut has a clear
margin and the selected indices must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.optim.api import get_optimizer
from repro_torch.optim.projected_adam import ProjAdamLeaf
from repro_torch.train.schedule import cosine_warmup

from test_torch_fused_step import SHAPES, planted

R = 6
MODES = ["off", "fft", "on"]


def _params(shape):
    """One low-rank leaf of ``shape`` and one full-rank leaf."""
    rng = np.random.default_rng(0)
    return {"block": {"w": {"kernel": rng.standard_normal(shape).astype(np.float32)}},
            "final_norm": {"scale": rng.standard_normal(shape[-1:]).astype(np.float32)}}


def _grads(shape, seed):
    """Planted in the oriented layout, handed over in the parameter's."""
    m, n = shape[-2:]
    if n <= m:
        g = planted(shape, seed)
    else:
        g = np.swapaxes(planted((*shape[:-2], n, m), seed), -1, -2).copy()
    norm = np.random.default_rng(seed + 100).standard_normal(shape[-1:])
    return {"block": {"w": {"kernel": g}},
            "final_norm": {"scale": norm.astype(np.float32)}}


def _close(got, want, msg=""):
    """rtol 1e-4, and atol 1e-4 of the largest entry: fp32 sums in
    different orders inside S, the moments and the back-projections, carried
    through the steps; the atol covers entries that cancel to ~0."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max(), err_msg=msg)


def _flat(tree):
    return {f"{a}/{b}/{c}" if c else f"{a}/{b}": v
            for a, sub in tree.items() for b, leaf in sub.items()
            for c, v in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)])}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_dct_adamw_steps_match_jax(mode, name):
    shape = SHAPES[name]
    params_np = _params(shape)
    kw = dict(rank=R, fused=mode, weight_decay=0.1)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, 10), **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, 10), **kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    # one JAX step first, so the carried state has non-zero moments, a
    # filled EF buffer, refreshed indices and inner_step 1
    _, jstate = jopt.update(jax.tree.map(jnp.asarray, _grads(shape, 10)),
                            jstate, jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tparams = convert.params_from_jax(params_np, device="cpu")
    assert tstate.step == 1 and set(tparams) == {"block/w/kernel",
                                                 "final_norm/scale"}

    for step in range(3):
        g_np = _grads(shape, 20 + step)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        jleaf = jstate.leaves[0]["lowrank"]["block"]["w"]["kernel"]
        tleaf = tstate.leaves[0]["lowrank"]["block/w/kernel"]
        assert isinstance(tleaf, ProjAdamLeaf)
        np.testing.assert_array_equal(tleaf.proj.numpy(),
                                      np.asarray(jleaf.proj))
        assert tleaf.inner_step == int(jleaf.inner_step)
        ju_flat = _flat(jax.tree.map(np.asarray, ju))
        for path, u in tu.items():
            _close(u.numpy(), ju_flat[path], f"{path} step {step}")
    # the int8 EF buffers. The residuals differ by fp32 summation order, so
    # a payload entry may round to the neighbouring code. Such a flip moves
    # one entry of the next G by one EF unit (its row scale): the next
    # residual's row max, and so its scale, by at most unit / 127, and an
    # entry of m by at most (1 - b1) * unit (|Q| <= 1)
    unit = float(tleaf.ef.scale.max())
    np.testing.assert_allclose(tleaf.ef.scale.numpy(),
                               np.asarray(jleaf.ef.scale), rtol=1e-5,
                               atol=unit / 127)
    assert np.abs(tleaf.ef.q.numpy().astype(int)
                  - np.asarray(jleaf.ef.q).astype(int)).max() <= 1
    np.testing.assert_allclose(tleaf.m.numpy(), np.asarray(jleaf.m),
                               rtol=1e-4, atol=0.1 * unit)
    # and an entry of v by at most (1 - b2) * (2 |g| unit + unit^2), with
    # |g| <= sqrt(v / (1 - b2)) since v >= (1 - b2) g^2
    v = np.asarray(jleaf.v)
    g_max = float(np.sqrt(v.max() / (1 - 0.999)))
    np.testing.assert_allclose(tleaf.v.numpy(), v, rtol=1e-4,
                               atol=1e-3 * (2 * g_max * unit + unit**2))


@pytest.mark.parametrize("interval", [2, 3])
def test_update_interval_keep_steps_match_jax(interval):
    """T_u > 1: the port's Python branch on the step against JAX's
    lax.cond, through refresh and keep steps."""
    shape = SHAPES["stacked"]
    params_np = _params(shape)
    kw = dict(rank=R, fused="on", update_interval=interval)
    jopt = jax_get_optimizer("dct_adamw", lr=0.01, **kw)
    topt = get_optimizer("dct_adamw", lr=0.01, **kw)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tparams = convert.params_from_jax(params_np, device="cpu")
    for step in range(5):
        g_np = _grads(shape, 30 + step)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        _close(tu["block/w/kernel"].numpy(),
               np.asarray(ju["block"]["w"]["kernel"]), f"step {step}")


def test_fp32_ef_state_carries_across():
    shape = SHAPES["odd"]
    params_np = _params(shape)
    jopt = jax_get_optimizer("dct_adamw", lr=0.01, rank=R, ef_dtype="fp32",
                             fused="off")
    topt = get_optimizer("dct_adamw", lr=0.01, rank=R, ef_dtype="fp32",
                         fused="off")
    jparams = jax.tree.map(jnp.asarray, params_np)
    _, jstate = jopt.update(jax.tree.map(jnp.asarray, _grads(shape, 40)),
                            jopt.init(jparams), jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tleaf = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    assert isinstance(tleaf.ef, torch.Tensor) and tleaf.ef.dtype == torch.float32
    g_np = _grads(shape, 41)
    ju, _ = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate, jparams)
    tu, _ = topt.update(convert.params_from_jax(g_np, device="cpu"), tstate,
                        convert.params_from_jax(params_np, device="cpu"))
    _close(tu["block/w/kernel"].numpy(), np.asarray(ju["block"]["w"]["kernel"]))


def test_init_state_layout_matches_jax():
    shape = SHAPES["transposed"]
    params_np = _params(shape)
    jstate = jax_get_optimizer("dct_adamw", lr=0.01, rank=R).init(
        jax.tree.map(jnp.asarray, params_np))
    tstate = get_optimizer("dct_adamw", lr=0.01, rank=R).init(
        convert.params_from_jax(params_np, device="cpu"))
    conv = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    assert tstate.bases.keys() == conv.bases.keys() == {"16"}
    np.testing.assert_allclose(tstate.bases["16"].numpy(),
                               conv.bases["16"].numpy(), atol=1e-6)
    assert tstate.bases_t["16"].is_contiguous()
    a = tstate.leaves[0]["lowrank"]["block/w/kernel"]
    b = conv.leaves[0]["lowrank"]["block/w/kernel"]
    for x, y in [(a.m, b.m), (a.v, b.v), (a.proj, b.proj), (a.ef.q, b.ef.q),
                 (a.ef.scale, b.ef.scale)]:
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)
    assert set(tstate.leaves[0]["full"]) == {"final_norm/scale"}


def lr_scale_cut_matches_jax(name, **kw):
    """``lr_scale=True`` builds the LR-cut seam: after a cut of 0.5 through
    ``scale_hyperparam`` in both packages, one update from a JAX-built,
    converted state equals JAX's at the preset tolerance of this file."""
    from repro.train.resilience import scale_hyperparam as jax_scale
    from repro_torch.train.resilience import scale_hyperparam
    rng = np.random.default_rng(5)
    params_np = {"block": {"w": {"kernel": rng.standard_normal(
        (40, 24)).astype(np.float32)}},
                 "final_norm": {"scale": np.ones(24, np.float32)}}
    g_np = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), params_np)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jopt = jax_get_optimizer(name, lr=0.01, lr_scale=True, **kw)
    jstate = jopt.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    jstate, jhits = jax_scale(jstate, "lr_scale", 0.5)
    tstate, thits = scale_hyperparam(tstate, "lr_scale", 0.5)
    assert jhits == thits == 1
    ju, _ = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate, jparams)
    tu, _ = get_optimizer(name, lr=0.01, lr_scale=True, **kw).update(
        convert.params_from_jax(g_np, device="cpu"), tstate,
        convert.params_from_jax(params_np, device="cpu"))
    for path in ("block/w/kernel", "final_norm/scale"):
        _close(tu[path].numpy(), np.asarray(
            convert.params_from_jax(jax.tree.map(np.asarray, ju),
                                    device="cpu")[path]))


@pytest.mark.parametrize("name", ["dct_adamw", "ldadamw", "galore",
                                  "frugal", "fira", "adamw"])
def test_unported_options_raise(name):
    """ZeRO-1 stays unported; the resilience ladder's ``lr_scale`` is ported
    and matches JAX under a cut of 0.5."""
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    if name == "adamw":                 # the JAX preset has no zero= either
        with pytest.raises(TypeError, match="unknown kwargs"):
            get_optimizer(name, lr=0.01, zero=None)
    else:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_optimizer(name, lr=0.01, zero=("data",))
    lr_scale_cut_matches_jax(name, **({} if name == "adamw" else {"rank": R}))
    with pytest.raises(ValueError, match="unknown residual"):
        ProjectedAdamRule(residual="nesterov")
    with pytest.raises(ValueError, match="unknown projector"):
        ProjectedAdamRule(projector="wavelet")
