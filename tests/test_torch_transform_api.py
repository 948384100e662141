"""The rest of the transform-chain runtime of the port: the legacy harness
``make_matrix_optimizer`` against the port's chain presets (bit for bit, as
``tests/test_transform_api.py`` pins the JAX package's), the harness and
``matrix_optimizer(fullrank_weight_decay=False)`` against the JAX package's
on the same numpy gradients and JAX's bases, and ``clip_global_norm``,
``scale_by_schedule`` and ``merge_by_label`` (with ``MaskedNode``) against
JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import common as jcommon
from repro.optim import transform as jtx
from repro.optim.projected_adam import ProjectedAdamRule as JaxProjectedAdamRule
from repro.optim.trion import TrionRule as JaxTrionRule
from repro_torch import convert
from repro_torch.core.error_feedback import QuantizedBuffer
from repro_torch.optim import transform as tx
from repro_torch.optim.api import OPTIMIZERS, get_optimizer
from repro_torch.optim.common import (HarnessState, default_label_fn,
                                      labelled_tree, make_matrix_optimizer)
from repro_torch.optim.dion import DionRule
from repro_torch.optim.muon import MuonRule
from repro_torch.optim.projected_adam import ProjectedAdamRule
from repro_torch.optim.trion import TrionRule

from test_torch_fused_step import SHAPES
from test_torch_optim import _close, _grads

LR = 2e-2


def _params():
    """tests/test_transform_api.py's shapes: plain, transposed, stacked,
    odd, and a 1-d bias (full-rank)."""
    rng = np.random.default_rng(0)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    return {"a/kernel": arr(24, 40), "b/kernel": arr(40, 24),
            "stacked/kernel": arr(3, 24, 40), "odd/kernel": arr(33, 17),
            "out_bias": torch.zeros(7)}


def _grad_seq(params, n, seed=5):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for k, p in params.items()} for _ in range(n)]


# the legacy wiring of each preset: the rule and the harness keywords
# (tests/test_transform_api.py's ``_legacy``)
def _legacy_args(name):
    if name == "adamw":
        return ProjectedAdamRule(), dict(weight_decay=0.01,
                                         label_fn=lambda path, leaf: "full")
    if name == "muon":
        return MuonRule(), dict(weight_decay=0.01)
    if name == "dion":
        return DionRule(rank=8), dict(weight_decay=0.01)
    if name == "trion":
        return TrionRule(rank=8), dict(weight_decay=0.01)
    rule = {
        "dct_adamw": ProjectedAdamRule(rank=8, projector="dct",
                                       update_interval=1, rotate=True,
                                       residual="ef", ef_dtype="q8"),
        "ldadamw": ProjectedAdamRule(rank=8, projector="power",
                                     update_interval=1, rotate=True,
                                     residual="ef", ef_dtype="fp32",
                                     needs_shared_basis=False),
        "galore": ProjectedAdamRule(rank=8, projector="svd",
                                    update_interval=5, rotate=False,
                                    residual="discard",
                                    needs_shared_basis=False),
        "frugal": ProjectedAdamRule(rank=8, projector="svd",
                                    update_interval=5, rotate=False,
                                    residual="sign", needs_shared_basis=False),
        "fira": ProjectedAdamRule(rank=8, projector="svd", update_interval=5,
                                  rotate=False, residual="fira",
                                  needs_shared_basis=False),
    }[name]
    return rule, dict(weight_decay=0.01, b1=rule.b1, b2=rule.b2, eps=rule.eps)


PRESET_KW = {
    "adamw": {}, "muon": {}, "dion": {"rank": 8}, "trion": {"rank": 8},
    "dct_adamw": {"rank": 8}, "ldadamw": {"rank": 8},
    "galore": {"rank": 8, "update_interval": 5},
    "frugal": {"rank": 8, "update_interval": 5},
    "fira": {"rank": 8, "update_interval": 5},
}


def _leaves(x, path=""):
    """``(path, tensor or int or None)`` of a leaf state, fields in order."""
    if isinstance(x, (torch.Tensor, int, float)) or x is None:
        yield path, x
    elif isinstance(x, QuantizedBuffer) or hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{path}.{f}")
    else:
        raise TypeError(f"{path}: {type(x)}")


def _assert_same(a, b, msg):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb], msg
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{msg} {p}"
        else:
            assert x == y, f"{msg} {p}"


def _run_pair(legacy, new, merge, name, label_fn=default_label_fn):
    params = _params()
    sl, sn = legacy.init(params), new.init(params)
    assert isinstance(sl, HarnessState)
    assert set(sl.bases) == set(sn.bases)
    for k in sl.bases:
        assert torch.equal(sl.bases[k], sn.bases[k])
        assert torch.equal(sl.bases_t[k], sn.bases_t[k])
    for t, g in enumerate(_grad_seq(params, 3)):
        ul, sl = legacy.update(g, sl, params)
        un, sn = new.update(g, sn, params)
        assert set(ul) == set(un) == set(params)
        for k in ul:
            assert torch.equal(ul[k], un[k]), f"{name} step {t} update {k}"
    assert sl.step == sn.step == 3
    merged = merge(sn.leaves, labelled_tree(params, label_fn))
    assert set(merged) == set(sl.leaves)
    for k in merged:
        _assert_same(sl.leaves[k], merged[k], f"{name} state {k}")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_harness_matches_chain_preset(name):
    """Bit for bit: updates and states, 3 steps, the presets' default fused
    mode (the reference path on the CPU)."""
    rule, kw = _legacy_args(name)

    def merge(leaves, labels):
        if name == "adamw":                 # chain(scale_by_adam, lr, decay)
            return leaves[0]
        return tx.merge_by_label(labels, leaves[0])

    _run_pair(make_matrix_optimizer(rule, LR, **kw),
              get_optimizer(name, lr=LR, **PRESET_KW[name]), merge, name)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_harness_matches_chain_without_fullrank_decay(name):
    """``fullrank_weight_decay=False``: the decay on the matrix leaves only,
    the partition of two chains against the harness, bit for bit."""
    rule, kw = _legacy_args(name)

    def merge(leaves, labels):
        # {"lowrank": (rule, lr, decay), "full": (adam, lr)}
        return tx.merge_by_label(labels, {lbl: sub[0]
                                          for lbl, sub in leaves.items()})

    _run_pair(make_matrix_optimizer(rule, LR, fullrank_weight_decay=False,
                                    **kw),
              tx.matrix_optimizer(rule, LR, fullrank_weight_decay=False, **kw),
              merge, name, kw.get("label_fn", default_label_fn))


def test_fullrank_weight_decay_false_spares_the_full_leaves():
    """The matrix leaves' updates are the same either way; a full leaf's
    (a non-zero bias here) lacks its ``-lr * wd * p`` without the decay."""
    params = {**_params(), "out_bias": torch.ones(7)}
    rule, kw = _legacy_args("dct_adamw")
    g = _grad_seq(params, 1)[0]
    outs = {}
    for fwd in (True, False):
        opt = tx.matrix_optimizer(rule, LR, fullrank_weight_decay=fwd, **kw)
        outs[fwd], _ = opt.update(g, opt.init(params), params)
    for k in ("a/kernel", "b/kernel", "stacked/kernel", "odd/kernel"):
        assert torch.equal(outs[True][k], outs[False][k]), k
    assert not torch.equal(outs[True]["out_bias"], outs[False]["out_bias"])
    torch.testing.assert_close(outs[True]["out_bias"],
                               outs[False]["out_bias"] - LR * 0.01,
                               rtol=0, atol=1e-7)


# -- against the JAX package ------------------------------------------------
R = 6


def _jax_rule(name):
    if name == "dct_adamw":
        return JaxProjectedAdamRule(rank=R, projector="dct", update_interval=1,
                                    rotate=True, residual="ef", ef_dtype="q8",
                                    fused="off")
    return JaxTrionRule(rank=R)


def _port_rule(name):
    if name == "dct_adamw":
        return ProjectedAdamRule(rank=R, projector="dct", update_interval=1,
                                 rotate=True, residual="ef", ef_dtype="q8",
                                 fused="off")
    return TrionRule(rank=R)


FACTORIES = {
    "harness": lambda pkg, rule: pkg[0].make_matrix_optimizer(
        rule, 0.01, weight_decay=0.1),
    "harness_no_fullrank_decay": lambda pkg, rule: pkg[0].make_matrix_optimizer(
        rule, 0.01, weight_decay=0.1, fullrank_weight_decay=False),
    "chain_no_fullrank_decay": lambda pkg, rule: pkg[1].matrix_optimizer(
        rule, 0.01, weight_decay=0.1, fullrank_weight_decay=False),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
@pytest.mark.parametrize("name", ["dct_adamw", "trion"])
def test_harness_and_chain_match_jax(name, factory):
    """3 updates from a fresh state on the same planted gradients (a clear
    top-r margin), the port on JAX's bases: tests/test_torch_optim.py's
    tolerance."""
    from repro_torch.optim import common as tcommon

    shape = SHAPES["stacked"]
    rng = np.random.default_rng(0)
    params_np = {"block": {"w": {"kernel": rng.standard_normal(shape)
                                 .astype(np.float32)}},
                 "final_norm": {"scale": rng.standard_normal(shape[-1:])
                                .astype(np.float32)}}
    jopt = FACTORIES[factory]((jcommon, jtx), _jax_rule(name))
    topt = FACTORIES[factory]((tcommon, tx), _port_rule(name))
    jparams = jax.tree.map(jnp.asarray, params_np)
    tparams = convert.params_from_jax(params_np, device="cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    bases = {k: torch.from_numpy(np.array(v)) for k, v in jstate.bases.items()}
    assert set(bases) == set(tstate.bases)
    tstate = tstate._replace(bases=bases, bases_t=tx.transposed(bases))
    for step in range(3):
        g_np = _grads(shape, 50 + step)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                 jparams)
        tu, tstate = topt.update(convert.params_from_jax(g_np, device="cpu"),
                                 tstate, tparams)
        jflat = convert.params_from_jax(jax.tree.map(np.asarray, ju),
                                        device="cpu")
        assert set(jflat) == set(tu)
        for k, u in tu.items():
            _close(u.numpy(), jflat[k].numpy(), f"{name} {k} step {step}")


def test_clip_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    g_np = {"w": rng.standard_normal((4, 6)).astype(np.float32) * 10,
            "b": rng.standard_normal((5,)).astype(np.float32)}
    for max_norm, scale in ((1.0, 1.0), (1e4, 1.0), (1.0, 1e-4)):
        jopt = jtx.as_optimizer(jtx.clip_global_norm(max_norm))
        topt = tx.as_optimizer(tx.clip_global_norm(max_norm))
        g = {k: v * scale for k, v in g_np.items()}
        jparams = {k: jnp.zeros_like(v) for k, v in g.items()}
        tparams = {k: torch.zeros(v.shape) for k, v in g.items()}
        ju, _ = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jparams),
                            jparams)
        tu, _ = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            topt.init(tparams), tparams)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6)
            assert tu[k].dtype == torch.float32
    norm = np.sqrt(sum(float((u.double() ** 2).sum()) for u in tu.values()))
    assert norm == pytest.approx(1e-4 * np.sqrt(
        sum(float((v.astype(np.float64) ** 2).sum()) for v in g_np.values())),
        rel=1e-6)


def test_clip_global_norm_widens_bf16_as_jax():
    g = {"w": torch.full((4, 4), 10.0, dtype=torch.bfloat16)}
    opt = tx.as_optimizer(tx.clip_global_norm(1.0))
    u, _ = opt.update(g, opt.init({"w": torch.zeros(4, 4)}), None)
    ju, _ = jtx.as_optimizer(jtx.clip_global_norm(1.0)).update(
        {"w": jnp.full((4, 4), 10.0, jnp.bfloat16)},
        jtx.as_optimizer(jtx.clip_global_norm(1.0)).init(
            {"w": jnp.zeros((4, 4))}), None)
    assert u["w"].dtype == torch.float32 and ju["w"].dtype == jnp.float32
    np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju["w"]), rtol=1e-6)


def test_scale_by_schedule_matches_jax():
    jopt = jtx.as_optimizer(jtx.scale_by_schedule(
        lambda t: 0.1 * t.astype(jnp.float32)))
    topt = tx.as_optimizer(tx.scale_by_schedule(lambda t: 0.1 * t))
    copt = tx.as_optimizer(tx.scale_by_schedule(0.25))
    g_np = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    js = jopt.init({"w": jnp.zeros((3, 5))})
    ts = topt.init({"w": torch.zeros(3, 5)})
    for step in range(1, 4):
        ju, js = jopt.update({"w": jnp.asarray(g_np)}, js, None)
        tu, ts = topt.update({"w": torch.from_numpy(g_np)}, ts, None)
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tu["w"].numpy(), 0.1 * step * g_np,
                                   rtol=1e-6)
    cu, _ = copt.update({"w": torch.from_numpy(g_np)},
                        copt.init({"w": torch.zeros(3, 5)}), None)
    np.testing.assert_allclose(cu["w"].numpy(), 0.25 * g_np, rtol=1e-6)


def test_merge_by_label_matches_jax_with_masked_holes():
    """JAX's per-label trees hold ``MASKED`` in the other labels' places;
    ``convert`` skips them (the port's ``MaskedNode`` by name), and the
    port's merge of the flat trees equals JAX's merge."""
    rng = np.random.default_rng(5)
    tree = {"attn": {"wq": rng.standard_normal((8, 16)).astype(np.float32)},
            "mlp": {"wi": rng.standard_normal((8, 16)).astype(np.float32)},
            "norm": rng.standard_normal((16,)).astype(np.float32)}

    def label_fn(path, leaf):
        return "attn" if "attn" in path else ("mlp" if "mlp" in path
                                              else "full")

    jlabels = jcommon.labelled_tree(tree, label_fn)
    jsub = {lbl: jtx._mask(jlabels, tree, lbl)
            for lbl in ("attn", "mlp", "full")}
    assert jsub["attn"]["mlp"]["wi"] == jtx.MASKED
    jmerged = convert.params_from_jax(jtx.merge_by_label(jlabels, jsub),
                                      device="cpu")
    tsub = {lbl: convert.params_from_jax(t, device="cpu")
            for lbl, t in jsub.items()}
    assert set(tsub["attn"]) == {"attn/wq"}          # the holes skipped
    flat = convert.params_from_jax(tree, device="cpu")
    tmerged = tx.merge_by_label(labelled_tree(flat, label_fn), tsub)
    assert list(tmerged) == list(flat)
    for k in flat:
        np.testing.assert_allclose(tmerged[k].numpy(), jmerged[k].numpy(),
                                   rtol=1e-6)
    # per-label trees that keep MASKED in the others' places merge the same
    holes = {lbl: {k: (v if labelled_tree(flat, label_fn)[k] == lbl
                       else tx.MASKED) for k, v in flat.items()}
             for lbl in tsub}
    assert all(torch.equal(tx.merge_by_label(labelled_tree(flat, label_fn),
                                             holes)[k], flat[k]) for k in flat)


def test_masked_node():
    assert tx.MASKED == tx.MaskedNode() and repr(tx.MASKED) == "MaskedNode"
    assert len({tx.MASKED, tx.MaskedNode()}) == 1 and tx.MASKED != 0
