"""Megatron's column / row compute in the port's train step under a mesh
(``parallel.fsdp.Held.use``'s Megatron route, ``models.layers.swiglu`` /
``gelu_mlp``, ``models.transformer._gqa_apply``), the two MoE layouts that
gather rows (``models.moe``), the clip's norm from the blocks' sums
(``sharding.sum_squares``) and ZeRO's rows moved from the parameter
blocks (``parallel.zero``), against the JAX package.

The meshes are the gloo worlds of ``tests/torch_zero_ranks.py`` (spawned
once a run and shared with ``test_torch_zero.py``, ``test_torch_fsdp.py``
and ``test_torch_mesh_models.py``): (1, 2) at 2 ranks, (2, 2) and (1, 4)
at 4. On a (data, model) mesh under ``fsdp_tp`` the reference's GSPMD
step multiplies each rank's ``model`` block: a column matrix's d_out, a
row matrix's d_in, the heads and the MLP's hidden units on ``model``, one
sum over ``model`` after each row product. The port's use sites hand those
leaves as this rank's blocks (gathered over the data axes only). At (1, 4)
the tiny configs' 2 kv heads do not split: their wk / wv come whole and
each rank picks the kv head its query head reads.

Bars: the reference's own (``tests/test_multidevice.py``): the loss within
1e-4, the logits at atol 2e-5 / rtol 1e-4; the gradients before the clip
at rtol 1e-4 of each leaf's largest entry; the parameters after one
DCT-AdamW step within ``STEP_LR_BAR`` lr of JAX's.
The MoE layouts at ``test_torch_mesh_models.py``'s bars (loss 1e-5,
gradients 1e-4). The clip factor within ``zr.CLIP_ULPS`` fp32 ulps of the
factor of the same gradients' one-process norm. ZeRO's updates and state
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zero_ranks as zr
from torch_threads import one_torch_thread  # noqa: F401 - autouse
from repro.configs import whisper_large_v3 as jax_whisper
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JaxModelConfig
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import steps as JS
from repro_torch.models import transformer as TT
from repro_torch.parallel import sharding

KEYS = ["1x2", "2x2", "1x4"]
WORLD = {"1x2": 2, "2x2": 4, "1x4": 4, "2": 2, "4": 4}
#: the parameters after one DCT-AdamW step against JAX's, in lr: Adam's
#: first step moves a weight by ~lr whatever |g|, and where the rule's
#: projected moments are ill-conditioned an fp32 difference in g moves it
#: by a share of lr (measured: up to 0.032 lr on one process, the tiny
#: llama's wk; the Megatron steps up to the same)
STEP_LR_BAR = 0.1
#: the key biases no rope follows (whisper's encoder and cross attention)
UNROPED_KEY_BIASES = ("encoder/blocks/attn/wk/bias", "xattn/wk/bias")


def _close(got, want, rtol=1e-4, msg=""):
    """rtol, and atol rtol of the largest entry (entries that cancel)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _jax_cfg(name: str, **kw):
    arch, fields = zr.MEG_CASES[name]
    if arch is None:
        return JaxModelConfig(**{**fields, **kw})
    return dataclasses.replace(jax_whisper.SMOKE, **fields, **kw)


def _jax_params(jcfg, tparams: dict):
    return jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.asarray(tparams[_path(kp)].numpy()),
        jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))


class _JaxCapture:
    """The JAX step's optimizer: the negated gradient as the update, the
    gradient itself as the new state."""

    @staticmethod
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    @staticmethod
    def update(grads, state, params):
        return jax.tree.map(lambda g: -g, grads), grads


def _flat(tree) -> dict:
    return {_path(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(jcfg, jparams, batch: dict, opt, **kw):
    state = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                          opt.init(jparams))
    return jax.jit(JS.make_train_step(jcfg, opt, **kw))(state, batch)


def _jax_meg(name: str, micro: int) -> dict:
    """JAX's one-device witnesses of a Megatron case: the logits, the
    loss and gradients of the step (no clipping; ``micro`` rows a
    microbatch, 0: the whole batch), and the parameters after one
    DCT-AdamW step."""
    tcfg = zr.meg_cfg(name)
    tparams, tbatch = zr.meg_params(tcfg), zr.meg_batch(tcfg)
    jcfg = _jax_cfg(name, train_microbatch=micro)
    jparams = _jax_params(jcfg, tparams)
    batch = {k: jnp.asarray(v.numpy(), jnp.int32 if v.dtype == torch.int64
                            else jnp.float32) for k, v in tbatch.items()}
    logits, _ = JT.forward(jparams, {k: v for k, v in batch.items()
                                     if k != "targets"}, jcfg)
    cap, m = _jax_step(jcfg, jparams, batch, _JaxCapture(), grad_clip=0.0)
    jopt = jax_get_optimizer("dct_adamw", lr=zr.MEG_LR, rank=zr.MEG_RANK,
                             fused="off")
    new, _ = _jax_step(jcfg, jparams, batch, jopt)
    return {"logits": np.asarray(logits), "loss": float(m["loss"]),
            "grads": _flat(cap.opt_state), "params": _flat(new.params)}


def _jax_route(micro: int) -> dict:
    """JAX's one-device step of TINY_MOE (drops) on the route batch, no
    clipping, ``micro`` rows a microbatch."""
    tcfg = zr.tiny_cfg(zr.TINY_MOE)
    jcfg = JaxModelConfig(**{**zr.TINY_MOE, "train_microbatch": micro})
    jparams = _jax_params(jcfg, TT.init_params(tcfg, 0, "cpu"))
    batch = {k: jnp.asarray(v.numpy(), jnp.int32)
             for k, v in zr.route_batch().items()}
    cap, m = _jax_step(jcfg, jparams, batch, _JaxCapture(), grad_clip=0.0)
    return {"loss": float(m["loss"]), "grads": _flat(cap.opt_state)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' results and the JAX witnesses computed here
    meanwhile."""
    root = zr.worlds_root(tmp_path_factory)
    procs = zr.start_worlds(root)
    try:
        ref = {"meg": {}, "route": {}}
        for name in zr.MEG_CASES:
            # a data shard of 2 rows routes alone (the MoE); the dense
            # configs compute one function of the batch whatever the cut
            for data in ((1, 2) if name == "moe" else (1,)):
                micro = 0 if data == 1 else zr.MEG_BATCH // data
                ref["meg"][name, data] = _jax_meg(name, micro)
        for micro in (0, zr.ROUTE_MICRO):
            ref["route"][micro] = _jax_route(micro)
        out = zr.world_results(root, procs)
    finally:
        for pr in (pr for ps in (procs or {}).values() for pr in ps):
            if pr.is_alive():
                pr.kill()
    out["ref"] = ref
    return out


def _case(worlds, key, name):
    return worlds[WORLD[key]][f"meg/{key}/{name}"]


def _tp(key) -> int:
    return int(key.split("x")[1])


@pytest.mark.parametrize("name", list(zr.MEG_CASES))
@pytest.mark.parametrize("key", KEYS)
def test_megatron_step_matches_jax(worlds, key, name):
    """One DCT-AdamW step with the dense products on each rank's model
    block: the loss, the no-grad forward's logits, every gradient the
    clip is handed, and the parameters after the step against the JAX
    package's one-device step on the same numpy-drawn values."""
    got = _case(worlds, key, name)
    data = int(key.split("x")[0])
    want = worlds["ref"]["meg"][name, data if name == "moe" else 1]
    assert abs(float(got["loss"]) - want["loss"]) < 1e-4, \
        (float(got["loss"]), want["loss"])
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               atol=2e-5, rtol=1e-4)
    assert set(got["pre_clip"]) == set(want["grads"])
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    for k, g in got["pre_clip"].items():
        if k.endswith(UNROPED_KEY_BIASES):
            # zero in exact arithmetic (a softmax is blind to a shift of
            # every score of a row): both held to that, as
            # test_torch_whisper.py holds them
            for v in (g.numpy(), want["grads"][k]):
                assert np.abs(v).max() <= 1e-6 * top, k
        else:
            _close(g.numpy(), want["grads"][k], msg=k)
    for k, p in got["params"].items():
        d = np.abs(p.numpy() - want["params"][k]).max()
        assert d <= STEP_LR_BAR * zr.MEG_LR, (k, d)


def _blocks(name: str, tp: int, paths) -> dict:
    """The whole (per-layer) and the model-block shape of each Megatron
    leaf ``paths``: a column leaf's d_out cut, a row leaf's d_in."""
    whole = TT.init_params(zr.meg_cfg(name), 0, "meta")
    out = {}
    for p in paths:
        shape = tuple(whole[p].shape[-2:])
        row = p.rsplit("/", 2)[-2] in ("wo", "wd") or p.endswith("/wd")
        out[p] = (shape, (shape[0] // tp, shape[1]) if row
                  else (shape[0], shape[1] // tp))
    return out


@pytest.mark.parametrize("name", list(zr.MEG_CASES))
@pytest.mark.parametrize("key", KEYS)
def test_sites_take_the_megatron_route(worlds, key, name):
    """Every attention and MLP group of every layer takes the Megatron
    route in the forward (the kv leaves too where the kv heads split over
    model; at (1, 4) the tiny configs' 2 kv heads come whole); a spy on the
    gathers: no Megatron leaf is gathered over model, each is gathered
    over the data axes only (with one data block, handed without a
    collective); the products run at the blocks' shapes."""
    got = _case(worlds, key, name)
    cfg, tp = zr.meg_cfg(name), _tp(key)
    fwd = [r for r in got["routes"] if r[0] == "forward"]
    assert fwd and all(r[3] == "megatron" for r in fwd), fwd
    meg = {p for r in fwd for p in r[5]}
    groups = {(r[1], r[2]) for r in fwd}
    layers = {r[1] for r in fwd}
    for tag in layers:
        assert any(g == "mlp/" or g == "moe/shared/" for t, g in groups
                   if t == tag), tag
    kv = {p for p in meg if p.endswith(("/wk/kernel", "/wv/kernel"))}
    assert bool(kv) == (cfg.n_kv_heads % tp == 0), sorted(kv)
    seen = set()
    for phase, tag, axes, paths, _ in got["gathers"]:
        if set(paths) & meg:
            assert "model" not in axes, (tag, axes, paths)
            assert set(axes) <= {"data"}, (tag, axes)
            seen |= set(paths) & meg
    assert seen == meg
    if cfg.n_kv_heads % tp:
        assert any("model" in axes and any(p.endswith("/wk/kernel")
                                           for p in paths)
                   for _, _, axes, paths, _ in got["gathers"])
    shapes = {tuple(s) for s in got["shapes"]}
    shp = _blocks(name, tp, meg)
    blocks = {b for _, b in shp.values()}
    assert blocks <= shapes, (blocks, shapes)
    assert not ({w for w, _ in shp.values()} - blocks) & shapes, shapes


@pytest.mark.parametrize("layout", zr.MEG_MOE_LAYOUTS)
@pytest.mark.parametrize("key", KEYS)
def test_moe_layouts_match_jax(worlds, key, layout):
    """TINY_MOE (capacity 1.0: drops) under ``pure_dp`` with a model axis
    (each rank's rows gathered over model: its data shard routed together)
    and in a ``decode_tp`` train step (the rows gathered over the data
    axes: the whole batch routed, as the reference replicates the
    tokens): the loss and every gradient against JAX's step routing the
    same tokens together (its microbatches of one data shard's rows under
    pure_dp at data 2)."""
    got = worlds[WORLD[key]][f"meg/{key}/moe_layout/{layout}"]
    data = int(key.split("x")[0])
    micro = zr.ROUTE_MICRO if layout == "pure_dp" and data == 2 else 0
    want = worlds["ref"]["route"][micro]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        _close(g.numpy(), want["grads"][k], msg=k)


def _norm_records(res: dict):
    for key, v in res.items():
        if isinstance(v, dict) and "norms" in v:
            norms = v["norms"].reshape(-1, 2)
            for n, w in norms.tolist():
                yield key, n, w


@pytest.mark.parametrize("world", [2, 4])
def test_clip_scale_within_ulps(worlds, world):
    """Every mesh step's clip factor in the world (data-only, Megatron and
    expert-parallel meshes; ZeRO off and on): the norm is the blocks'
    sums of squares completed by one all-reduce, no gradient gathered;
    its factor within ``zr.CLIP_ULPS`` fp32 ulps of the factor of the same
    whole gradients' one-process norm, and the clip acts in most
    steps."""
    recs = list(_norm_records(worlds[world]))
    assert len(recs) > 20, len(recs)
    worst = max(zr.ulps(zr.clip_scale(torch.tensor(n)),
                        zr.clip_scale(torch.tensor(w))) for _, n, w in recs)
    assert worst <= zr.CLIP_ULPS, worst
    assert sum(w > 1.0 for _, _, w in recs) > len(recs) // 2


@pytest.mark.parametrize("key", ["2", "4", "2x2"])
def test_zero_rows_without_the_whole_leaf(worlds, key):
    """DCT-AdamW with ZeRO-1 handed the gradient blocks of ``fsdp_tp``
    (``("data",)`` at 2 and 4 ranks, (2, 2)): two updates and the state
    bit-equal to the replicated optimizer's; no leaf gathered whole
    (``sharding.gather``); the rows move by all-to-all, each rank sending
    less than the parameters' bytes, and the all-gathers carry only the
    selection's column statistics."""
    got = worlds[WORLD[key]][f"meg/{key}/zero_rows"]
    assert all(got["updates_equal"]) and got["state_equal"], got
    assert got["whole_gathers"] == [[], []], got["whole_gathers"]
    total = sum(got["leaf_bytes"].values())
    for c in got["counts"]:
        assert 0 < c["all_to_all"][1] < total, (c, total)
        assert c["all_gather"][1] < 0.05 * total, (c, total)
