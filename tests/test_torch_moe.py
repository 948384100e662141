"""The MoE FFN of the port (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``, one device) on numpy-drawn parameters
and inputs, at deepseek-moe-16b's smoke config (d=128, 8 experts top-2,
expert hidden 64, 2 shared experts of 64 in all, fp32).

Routing is discrete: a token's expert set flips if two router
probabilities swap order, so the inputs are drawn where the top-k's gaps
are far above fp32 rounding (the test asserts them), and then the outputs
match at rtol 1e-5 (fp32 sums in another order, ~1e-7 relative per op)
and the gradients at rtol 1e-4 (through the softmax, the gate
renormalisation and three products). With ``capacity_factor`` 8.0 (the
smoke configs') no token is dropped; with 1.25 and inputs that crowd two
experts, the test asserts that some pairs overflow and are dropped in the
same way.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jax_dsm
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

JCFG = jax_dsm.SMOKE
CFG = get_config("deepseek-moe-16b", smoke=True)
RTOL, GRAD_RTOL = 1e-5, 1e-4
B, S = 2, 16


def _cfgs(capacity_factor):
    return (dataclasses.replace(JCFG, capacity_factor=capacity_factor),
            dataclasses.replace(CFG, capacity_factor=capacity_factor))


def _params(seed=0, router_scale=1.0):
    """JAX's ``moe`` subtree of one block drawn by numpy (N(0, 1/d_in) as
    the init's scales; the router times ``router_scale``), and the port's
    flat copy."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda k: JM.init_moe(k, JCFG),
                          jax.random.PRNGKey(0))

    def draw(kp, leaf):
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        scale = router_scale if path.startswith("router") else 1.0
        return (rng.standard_normal(leaf.shape) * scale
                * leaf.shape[-2] ** -0.5).astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(draw, tree)
    return jp, convert.params_from_jax(jp, device="cpu")


def _inputs(seed, crowd=0.0):
    """x (B, S, d); ``crowd`` > 0 adds one shared direction to every token,
    which sends them to the same experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, JCFG.d_model)).astype(np.float32)
    return x + crowd * rng.standard_normal(JCFG.d_model).astype(np.float32)


@pytest.fixture(scope="module")
def jfns():
    """JAX's ``moe_ffn`` and its gradient, jitted once per capacity."""
    out = {}
    for cf in (8.0, 1.25):
        jcfg = _cfgs(cf)[0]

        def f(p, x, jcfg=jcfg):
            return JM.moe_ffn(p, x, jcfg)

        def loss(p, x, w, jcfg=jcfg):
            y, aux = JM.moe_ffn(p, x, jcfg)
            return jnp.sum(y * w) + aux

        out[cf] = (jax.jit(f), jax.jit(jax.grad(loss, argnums=(0, 1))))
    return out


def _route(tp, x, cfg):
    """The port's routing of x: (probs, gate_e, positions in each expert,
    capacity)."""
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ tp["router/kernel"], -1)
    _, gate_e = TM.top_k(probs, cfg.moe_top_k)
    flat = gate_e.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, cfg.n_experts)
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(1)
    return probs, gate_e, pos, TM.capacity(xf.shape[0], cfg)


def _assert_clear_margins(probs, k):
    """The k-th and (k+1)-th router probabilities of every token part by
    far more than fp32 rounding: the top-k sets cannot flip."""
    top = torch.sort(probs, -1, descending=True).values
    assert float((top[:, k - 1] - top[:, k]).min()) > 1e-5


def test_configs_and_capacity_match_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert CFG.capacity_factor == 8.0 and CFG.n_shared_experts == 2
    for t in (1, 2, 7, 32, 100, 4096):
        for cf in (8.0, 1.25):
            cfg = dataclasses.replace(CFG, capacity_factor=cf)
            cap = int(math.ceil(t * cfg.moe_top_k / cfg.n_experts * cf))
            assert TM.capacity(t, cfg) == max(8, -(-cap // 8) * 8)


def test_init_moe_leaves_match_jax():
    want = {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda k: JM.init_moe(k, JCFG),
                               jax.random.PRNGKey(0)))[0]}
    got = TM.init_moe(torch.Generator().manual_seed(0), CFG)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == \
        {k: (leaf.shape, leaf.dtype.name) for k, leaf in want.items()}
    assert got["router/kernel"].dtype == torch.float32
    meta = TM.init_moe(None, CFG, batch=(3,), device="meta")
    assert tuple(meta["experts/wg"].shape) == (3, 8, 128, 64)


def test_top_k_breaks_ties_like_jax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TM.top_k(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert torch.equal(tv, torch.from_numpy(np.array(jv)))


@pytest.mark.parametrize("capacity_factor,crowd", [(8.0, 0.0), (1.25, 3.0)])
def test_moe_ffn_matches_jax(jfns, capacity_factor, crowd):
    """Outputs and aux at rtol 1e-5; with 1.25 and crowded inputs some pairs
    overflow their expert's capacity (asserted) and both drop the same."""
    jcfg, tcfg = _cfgs(capacity_factor)
    jp, tp = _params(1)
    x = _inputs(2, crowd)
    probs, _, pos, cap = _route(tp, x, tcfg)
    _assert_clear_margins(probs, tcfg.moe_top_k)
    dropped = int((pos >= cap).sum())
    assert (dropped > 0) == (capacity_factor < 8.0), dropped
    jy, jaux = jfns[capacity_factor][0](jp, jnp.asarray(x))
    ty, taux = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    want = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("capacity_factor,crowd", [(8.0, 0.0), (1.25, 3.0)])
def test_moe_ffn_grads_match_jax(jfns, capacity_factor, crowd):
    """The gradient of sum(y * w) + aux with respect to every parameter and
    to x, at rtol 1e-4 of each leaf's largest entry."""
    _, tcfg = _cfgs(capacity_factor)
    jp, tp = _params(1)
    x = _inputs(2, crowd)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jgp, jgx = jfns[capacity_factor][1](jp, jnp.asarray(x), jnp.asarray(w))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TM.moe_ffn(leaves, tx, tcfg)
    (torch.sum(ty * torch.from_numpy(w)) + taux).backward()
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgp),
                                   device="cpu")
    want["x"] = torch.from_numpy(np.array(jgx))
    got = {**{k: v.grad for k, v in leaves.items()}, "x": tx.grad}
    assert set(got) == set(want)
    for k, g in got.items():
        ref = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=k)


def test_moe_ffn_bf16_cast_params_match_jax(jfns):
    """The model's mixed precision: ``cast_params`` rounds the router to
    bf16 in both packages (its path holds no precision-critical name) and
    the router widens it to fp32; bf16 inputs and experts. The top-k sets
    equal (asserted through the margins) and the outputs within 1e-2 of max
    |out| (bf16 products rounded where the frameworks sum in another
    order: about two bf16 ulps), aux at rtol 1e-5."""
    jcfg = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    jp, _ = _params(4)
    jtree = JT.cast_params({"moe": jax.tree.map(jnp.asarray, jp)}, jcfg)
    assert jtree["moe"]["router"]["kernel"].dtype == jnp.bfloat16
    tp = TT.cast_params(convert.params_from_jax({"moe": jp}, device="cpu"),
                        tcfg)
    assert tp["moe/router/kernel"].dtype == torch.bfloat16
    x = _inputs(5).astype(jnp.bfloat16)
    jy, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, x, jcfg))(
        jtree["moe"], jnp.asarray(x))
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    ty, taux = TM.moe_ffn({k[4:]: v for k, v in tp.items()}, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    probs = torch.softmax(tx.float().reshape(-1, 128)
                          @ tp["moe/router/kernel"].float(), -1)
    _assert_clear_margins(probs, tcfg.moe_top_k)
    want = np.asarray(jy.astype(jnp.float32))
    assert np.abs(ty.float().numpy() - want).max() <= \
        1e-2 * np.abs(want).max()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)


def test_combine_adds_the_k_slots_in_order(monkeypatch):
    """The combine runs no scatter-add or ``index_add_`` (whose atomics on
    the card add in a run-dependent order): those calls raise here, and the
    output equals a loop over tokens adding their k contributions in slot
    order."""
    def refuse(*a, **k):
        raise AssertionError("scatter-add in the MoE path")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "index_add", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    _, tp = _params(6)
    x = torch.from_numpy(_inputs(7))
    y, _ = TM._local_moe(x, tp["router/kernel"], tp["experts/wg"],
                         tp["experts/wu"], tp["experts/wd"], cfg=CFG)
    xf = x.reshape(-1, CFG.d_model)
    probs = torch.softmax(xf @ tp["router/kernel"], -1)
    gw, ge = TM.top_k(probs, CFG.moe_top_k)
    gw = gw / gw.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for i in range(xf.shape[0]):
        for j in range(CFG.moe_top_k):
            e = int(ge[i, j])
            h = torch.nn.functional.silu(xf[i] @ tp["experts/wg"][e]) \
                * (xf[i] @ tp["experts/wu"][e])
            want[i] = want[i] + (h @ tp["experts/wd"][e]) * gw[i, j]
    torch.testing.assert_close(y.reshape(-1, CFG.d_model), want, rtol=1e-5,
                               atol=1e-6)
