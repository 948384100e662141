"""FSDP's schedule of the port's train step (``repro_torch.parallel.fsdp``)
on the gloo worlds of ``tests/torch_zero_ranks.py``: 2 ranks over
``("data",)`` (mesh key "2"), (1, 2) and (2, 1), and 4 ranks over (2, 2),
spawned once a run and shared with ``test_torch_zero.py`` and
``test_torch_mesh_models.py`` (``zr.start_worlds``). This module computes
the one-process and JAX witnesses while they run.

Under ``fsdp_tp`` the step holds the parameters as blocks: each use site
(the embedding, a layer, the head) gathers its split weights as it runs
and again in the backward (the remat recomputation, or the saved-tensor
hooks' unpack), each gradient comes back as this rank's block of its mean
over the data axes, and the update runs on blocks.

Bars: where the gradients average two shares the step is the one-process
step in microbatches of one rank's rows, bit for bit (remat on and off,
ZeRO-1 off and on, the reduce-scatter and the all-reduce routes of the
reduction); against JAX's one-device step on the global batch the loss at
rtol 1e-5 and every gradient at rtol 1e-4 of its leaf's largest entry
(``test_torch_mesh_models.py``'s bars); a microbatched mesh step reduces
each microbatch's blocks before adding them (another order than one
process), held to the whole-batch step at the JAX package's own
microbatch bar (``tests/test_train_substrate.py``: atol 1e-5, rtol 1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zero_ranks as zr
from torch_threads import one_torch_thread  # noqa: F401 - autouse
from repro.configs import llama_paper as jax_llama
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT

# mesh key -> (world, data blocks)
MESHES = {"2": (2, 2), "1x2": (2, 1), "2x1": (2, 2), "2x2": (4, 2)}
MODEL_MESHES = ["1x2", "2x1", "2x2"]
# the meshes whose model axis has two ranks: Megatron's dense products
MEGATRON_MESHES = ["1x2", "2x2"]
SPIES = [("moe", False), ("moe", True), ("llama", True)]


def _close(got, want, rtol=1e-4, msg=""):
    """rtol, and atol rtol of the largest entry (entries that cancel)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


class _JaxCapture:
    """The JAX step's optimizer: the negated gradient as the update, the
    gradient itself as the new state."""

    @staticmethod
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    @staticmethod
    def update(grads, state, params):
        return jax.tree.map(lambda g: -g, grads), grads


def _jax_step(tparams: dict, batch: dict) -> dict:
    """JAX's one-device train step of the smoke llama (no clipping) on the
    global batch, from the port's parameter values."""
    jcfg = jax_llama.SMOKE          # the smoke llama's own fields
    jparams = jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.asarray(tparams[_path(kp)].numpy()),
        jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    opt = _JaxCapture()
    state = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                          opt.init(jparams))
    new, m = jax.jit(JS.make_train_step(jcfg, opt, grad_clip=0.0))(
        state, {k: jnp.asarray(v.numpy(), jnp.int32)
                for k, v in batch.items()})
    return {"loss": float(m["loss"]),
            "grads": {_path(kp): np.asarray(g) for kp, g in
                      jax.tree_util.tree_flatten_with_path(
                          new.opt_state)[0]}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' results and the witnesses computed here meanwhile."""
    root = zr.worlds_root(tmp_path_factory)
    procs = zr.start_worlds(root)
    try:
        cfg = get_config(zr.TRAIN["arch"], smoke=True)
        params = TT.init_params(cfg, 0, "cpu")
        batch = zr.make_batch(cfg)
        ref = {"run": {mb: zr.run_record(zr.placed_run(
                   "dct_adamw", "off", microbatch=mb)) for mb in (0, 2)},
               "jax": _jax_step(params, batch),
               "micro": zr.captured_step(dataclasses.replace(
                   cfg, train_microbatch=zr.FSDP_MICRO), params, batch)}
        out = zr.world_results(root, procs)
    finally:
        for pr in (pr for ps in (procs or {}).values() for pr in ps):
            if pr.is_alive():
                pr.kill()
    out["ref"] = ref
    return out


def _witness(worlds, key):
    """The one-process run in microbatches of one data rank's rows."""
    rows = zr.TRAIN["batch"] // MESHES[key][1]
    return worlds["ref"]["run"][0 if rows == zr.TRAIN["batch"] else rows]


def _assert_equal_runs(got, want, what):
    assert torch.equal(got["losses"], want["losses"]), \
        (what, got["losses"], want["losses"])
    for part in ("params", "opt_state"):
        assert set(got[part]) == set(want[part]), (what, part)
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (what, part, k)


@pytest.mark.parametrize("zero_mode", ["off", "1"])
@pytest.mark.parametrize("key", list(MESHES))
def test_remat_step_matches_one_process(worlds, key, zero_mode):
    """The smoke llama's two DCT-AdamW steps (int8 EF) with ``cfg.remat``:
    each layer gathered in the forward and gathered again by its
    recomputation. On the data-only meshes the first step's loss and its
    gradients before the clip are bit-equal to one process in microbatches
    of one data rank's rows (remat off there), every clip factor within
    ``zr.CLIP_ULPS`` of the whole gradients' (the norm sums the blocks),
    and the rest of the run within ``zr.assert_clipped_runs``' bars; on a
    model axis the dense products run on the model blocks (Megatron) and
    the first step is held at the reference's bars."""
    got = worlds[MESHES[key][0]][f"fsdp/{key}/remat/{zero_mode}"]
    zr.assert_clipped_runs(got, _witness(worlds, key), (key, zero_mode),
                           megatron=key in MEGATRON_MESHES)


@pytest.mark.parametrize("key", list(MESHES))
def test_all_reduce_route_matches_one_process(worlds, key):
    """The gradients' reduction as an all-reduce and a cut (the route of a
    backend without a reduce-scatter) against the one-process witness as
    the reduce-scatter route is held (``zr.assert_clipped_runs``)."""
    got = worlds[MESHES[key][0]][f"fsdp/{key}/all_reduce_route"]
    zr.assert_clipped_runs(got, _witness(worlds, key), (key, "all_reduce"),
                           megatron=key in MEGATRON_MESHES)


@pytest.mark.parametrize("key", MODEL_MESHES)
def test_moe_remat_step_equals_no_remat(worlds, key):
    """deepseek-moe-16b's smoke model, two DCT-AdamW steps expert-parallel
    with the experts held by their ``model`` block: with ``cfg.remat`` the
    same bits as without (``test_torch_mesh_models.py`` holds that run to
    one process)."""
    res = worlds[MESHES[key][0]]
    _assert_equal_runs(res[f"fsdp/{key}/ep_remat"],
                       res[f"ep_step/{key}/off"], (key, "moe remat"))


@pytest.mark.parametrize("key", list(MESHES))
def test_step_matches_jax_one_device(worlds, key):
    """The smoke llama's train step (no clipping) on the mesh against the
    JAX package's jitted one-device step on the global batch, the same
    numpy-drawn inputs: the loss at rtol 1e-5, every gradient (gathered
    from the blocks the optimizer is handed) at rtol 1e-4."""
    got = worlds[MESHES[key][0]][f"fsdp/{key}/micro/0"]
    want = worlds["ref"]["jax"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        _close(g.numpy(), want["grads"][k], msg=k)


@pytest.mark.parametrize("key", list(MESHES))
def test_microbatched_mesh_step_within_bar(worlds, key):
    """``train_microbatch`` 1 on the mesh: each microbatch's backward
    reduces its blocks and the step adds them, where one process adds the
    microbatches first. Loss and gradients against the whole-batch mesh
    step and against one process's microbatched step at the JAX package's
    microbatch bar (atol 1e-5, rtol 1e-3)."""
    res = worlds[MESHES[key][0]]
    got = res[f"fsdp/{key}/micro/{zr.FSDP_MICRO}"]
    for want in (res[f"fsdp/{key}/micro/0"], worlds["ref"]["micro"]):
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][k].numpy(),
                                       atol=1e-5, rtol=1e-3, err_msg=k)


def _sites(rec):
    """``{(tag, phase): [(axes, paths, bytes), ...]}`` of a spy record."""
    out = {}
    for phase, tag, axes, paths, nbytes in rec["log"]:
        out.setdefault((tag, phase), []).append((tuple(axes), paths, nbytes))
    return out


@pytest.mark.parametrize("model,remat", SPIES)
@pytest.mark.parametrize("key", list(MESHES))
def test_each_layer_gathered_once_each_way(worlds, key, model, remat):
    """A spy on the gathers of one forward and backward (the tiny MoE with
    and without ``cfg.remat``, the smoke llama with it): each layer's split
    leaves are handed together once in the forward and once in the
    backward (one collective per group of mesh axes; an expert or
    Megatron leaf with one data block as its block, no collective), the
    embedding and the head once in the forward; no all-gather carries the
    whole parameter tree; under ``fsdp_tp`` no expert leaf and no leaf of
    a Megatron group is gathered over ``model``, and with a model axis of
    two ranks every attention and MLP matrix is a Megatron leaf."""
    rec = worlds[MESHES[key][0]][f"fsdp/{key}/spy/{model}/{remat}"]
    sites = _sites(rec)
    layers = {tag for tag, _ in sites if tag.startswith("segments/")}
    assert layers, sites.keys()
    for tag in layers:
        fwd, bwd = sites[tag, "forward"], sites.get((tag, "backward"))
        assert bwd is not None, tag
        assert sorted(a for a, _, _ in fwd) == sorted(a for a, _, _ in bwd)
        assert len({a for a, _, _ in fwd}) == len(fwd), (tag, fwd)
        pre = tag[:tag.rindex("/") + 1]
        want = {k for k in rec["split"] if k.startswith(pre)}
        assert {p for _, paths, _ in fwd for p in paths} == want, tag
        assert sorted(p for _, paths, _ in fwd for p in paths) == \
            sorted(p for _, paths, _ in bwd for p in paths), tag
    for tag in ("embed", "head"):
        assert len(sites[tag, "forward"]) >= 1
        assert len(sites.get((tag, "backward"), [])) <= \
            len(sites[tag, "forward"])
    tree = sum(rec["whole_bytes"][k] for k in rec["split"])
    assert rec["gather_bytes"] and max(rec["gather_bytes"]) < tree, \
        (max(rec["gather_bytes"]), tree)
    meg = set(rec["megatron"])
    if key in MEGATRON_MESHES:
        assert meg == {k for k in rec["split"] if k.startswith("segments/")
                       and any(f"/{g}/" in k for g in ("attn", "mlp"))
                       and not k.endswith("/router/kernel")}, sorted(meg)
    else:
        assert not meg, sorted(meg)
    if key != "2":
        for axes, paths, _ in (e for v in sites.values() for e in v):
            assert not ("model" in axes
                        and any("experts/" in p or p in meg
                                for p in paths)), paths


@pytest.mark.parametrize("model,remat", SPIES)
@pytest.mark.parametrize("key", list(MESHES))
def test_live_whole_bytes_bounded(worlds, key, model, remat):
    """The whole weights alive at once, counted by the gather-on-use
    function: at most two layers' worth plus the largest non-layer leaf,
    none left after the backward; every gradient leaving the backward has
    its block's shape."""
    rec = worlds[MESHES[key][0]][f"fsdp/{key}/spy/{model}/{remat}"]
    per_site = {}
    for phase, tag, _, _, nbytes in rec["log"]:
        if phase == "forward" and tag.startswith("segments/"):
            per_site[tag] = per_site.get(tag, 0) + nbytes
    top = max(v for k, v in rec["whole_bytes"].items()
              if not k.startswith("segments/"))
    assert rec["peak_live"] <= 2 * max(per_site.values()) + top, \
        (rec["peak_live"], per_site, top)
    assert rec["live_after"] == 0
    assert rec["block_shapes"]
