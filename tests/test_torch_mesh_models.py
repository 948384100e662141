"""The models' mesh bodies of the port against one process and the JAX
package: MoE routing over the whole batch on a data mesh, expert-parallel
``moe_ffn`` over ``model`` (and ``decode_tp``'s experts cut over the data
axes too), sequence-parallel attention over ``model``, and both in the
train step.

The meshes are the gloo worlds of ``tests/torch_zero_ranks.py`` (2 ranks:
``("data",)``, (1, 2) and (2, 1); 4 ranks: ``("data",)`` and (2, 2)),
spawned once a run and shared with ``test_torch_zero.py``
(``zr.start_worlds``); this module computes the one-process and JAX
witnesses while they run.

The reference's functions on a mesh are those of the global batch:
without a ``model`` axis ``moe_ffn`` routes the whole batch as one (the
JAX package's one-device step, here fed the same numpy-drawn inputs);
with one, each data shard routes its own rows and the aux is the shards'
mean, so its one-device witness runs one shard's rows at a time. Every
case drops tokens (capacity factor 1.0) unless it says otherwise.

Bars: losses and the aux at rtol 1e-5, gradients at rtol 1e-4 (atol 1e-4
of the leaf's largest entry), as ``test_torch_deepseek.py`` holds the
port to JAX; fp32 attention outputs at 3e-5 (``test_torch_layers.py``);
``decode_tp`` logits at the reference's own bar (``tests/
test_multidevice.py``: atol 2e-5, rtol 1e-4); the loss with ``attn_sp`` on
and off within 1e-4 (its bar there). Within the port, where no sum is
split across ranks, the mesh equals one process bit for bit.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zero_ranks as zr
from torch_threads import one_torch_thread  # noqa: F401 - autouse
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JaxModelConfig
from repro.train import steps as JS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

fa = importlib.import_module("repro_torch.kernels.flash_attention")

MESH_SHAPES = [s for ss in zr.MESHES.values() for s in ss]
TOL = dict(rtol=1e-5)


def _close(got, want, rtol=1e-4, msg=""):
    """rtol, and atol rtol of the largest entry (entries that cancel)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _jax_cfg(fields: dict, **kw):
    return JaxModelConfig(**{**fields, **kw})


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _jax_params(jcfg, tparams: dict):
    """JAX's parameter tree of ``jcfg`` holding the port's values."""
    return jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.asarray(tparams[_path(kp)].numpy()),
        jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))


class _JaxCapture:
    """The JAX step's optimizer: the negated gradient as the update, the
    gradient itself as the new state (out of the jitted step)."""

    @staticmethod
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    @staticmethod
    def update(grads, state, params):
        return jax.tree.map(lambda g: -g, grads), grads


def _jax_step(jcfg, jparams, batch: dict) -> dict:
    """The JAX package's one-device train step (no clipping, jitted) on
    the global batch: loss, ce and the gradient keyed as the port's
    leaves."""
    opt = _JaxCapture()
    state = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                          opt.init(jparams))
    new, m = jax.jit(JS.make_train_step(jcfg, opt, grad_clip=0.0))(
        state, {k: jnp.asarray(v.numpy(), jnp.int32)
                for k, v in batch.items()})
    grads = {_path(kp): np.asarray(g) for kp, g in
             jax.tree_util.tree_flatten_with_path(new.opt_state)[0]}
    return {"loss": float(m["loss"]), "ce": float(m["ce"]), "grads": grads}


def _shards(x, n):
    return [x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
            for i in range(n)]


def _port_moe_witness(p, x, w, n: int) -> dict:
    """The reference's EP function on one process: each of ``n`` data
    shards routed alone (``moe_ffn`` with no mesh), the aux their mean;
    the gradients of ``sum(out * w) + aux``."""
    cfg = zr.tiny_cfg(zr.TINY_MOE, n_shared_experts=2, shared_d_ff=32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    outs, auxs = zip(*(TM.moe_ffn(leaves, xs, cfg) for xs in _shards(xg, n)))
    out, aux = torch.cat(outs), sum(auxs) / n
    g = torch.autograd.grad((out * w).sum() + aux, [xg, *leaves.values()])
    return {"out": out.detach(), "aux": aux.detach(),
            "grads": dict(zip(["x", *leaves], g))}


def _jax_moe_witness(p, x, w, n: int) -> dict:
    """The same function with the JAX package's ``moe_ffn``."""
    jcfg = _jax_cfg(zr.TINY_MOE, n_shared_experts=2, shared_d_ff=32)
    tree = {"router": {"kernel": None}, "experts": {}, "shared": {}}
    for k, v in p.items():
        a, b = k.split("/")
        tree[a][b] = jnp.asarray(v.numpy())

    def f(xx, tr):
        outs, auxs = zip(*(JM.moe_ffn(tr, xs, jcfg)
                           for xs in _shards(xx, n)))
        return jnp.concatenate(outs), sum(auxs) / n

    def loss(xx, tr):
        out, aux = f(xx, tr)
        return (out * jnp.asarray(w.numpy())).sum() + aux

    xj = jnp.asarray(x.numpy())
    out, aux = jax.jit(f)(xj, tree)
    gx, gt = jax.jit(jax.grad(loss, argnums=(0, 1)))(xj, tree)
    grads = {"x": np.asarray(gx)}
    grads.update({_path(kp): np.asarray(g) for kp, g in
                  jax.tree_util.tree_flatten_with_path(gt)[0]})
    return {"out": np.asarray(out), "aux": float(aux), "grads": grads}


def _jax_sp(case: str) -> dict:
    """JAX's ``blockwise_attention`` on the SP case (one device) and the
    gradients of ``sum(out * w)``."""
    q, k, v, w, kw = zr.sp_inputs(case)
    args = [jnp.asarray(t.numpy()) for t in (q, k, v)]

    def f(q_, k_, v_):
        return JL.blockwise_attention(q_, k_, v_, **kw, **zr.SP_CHUNKS)

    out = jax.jit(f)(*args)
    g = jax.jit(jax.grad(lambda *a: (f(*a) * jnp.asarray(w.numpy())).sum(),
                         argnums=(0, 1, 2)))(*args)
    return {"out": np.asarray(out), "grads": dict(zip("qkv", map(np.asarray,
                                                                  g)))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' results and the witnesses computed here meanwhile."""
    root = zr.worlds_root(tmp_path_factory)
    procs = zr.start_worlds(root)
    try:
        ref = {"route": {}, "moe": {}, "sp": {}, "sp_step": {}}
        batch = zr.route_batch()
        for mb in (0, zr.ROUTE_MICRO):
            tcfg = zr.tiny_cfg(zr.TINY_MOE, train_microbatch=mb)
            tparams = TT.init_params(tcfg, 0, "cpu")
            jcfg = _jax_cfg(zr.TINY_MOE, train_microbatch=mb)
            jparams = _jax_params(jcfg, tparams)
            ref["route"][mb] = _jax_step(jcfg, jparams, batch)
            if mb == 0:
                _, jaux = JT.forward(jparams, {"tokens": jnp.asarray(
                    batch["tokens"].numpy(), jnp.int32)}, jcfg)
                ref["route"]["aux"] = float(jaux["moe_aux"])
                ref["route"]["port_one"] = zr.routing_run()
                # what the parent tree computed at 2 ranks: each rank's
                # rows routed alone, the two averaged (= one process in
                # microbatches of one rank's rows)
                ref["route"]["local"] = zr.captured_step(
                    dataclasses.replace(tcfg, train_microbatch=4), tparams,
                    batch)
        # with a model axis each data shard routes its own rows: JAX's
        # step in microbatches of one shard's rows (at data 1 the whole
        # batch, at data 2 microbatches of ROUTE_MICRO = 8 / 2 rows)
        ref["route"]["ep1"] = ref["route"][0]
        ref["route"]["ep2"] = ref["route"][zr.ROUTE_MICRO]
        p, x, w = zr.moe_inputs()
        for n in (1, 2):
            ref["moe"][n] = (_port_moe_witness(p, x, w, n),
                             _jax_moe_witness(p, x, w, n))
        for case in zr.SP_CASES:
            # with no mesh SP is the port's plain blockwise attention
            ref["sp"][case] = (zr.sp_grads(case), _jax_sp(case))
        ref["ep_step"] = {mb: zr.run_record(zr.placed_run(
            "dct_adamw", "off", microbatch=mb, arch=zr.EP_ARCH))
            for mb in (0, 2)}
        jcfg = _jax_cfg(zr.TINY_MOE, capacity_factor=8.0)
        tcfg = zr.tiny_cfg(zr.TINY_MOE, capacity_factor=8.0)
        tparams = TT.init_params(tcfg, 3, "cpu")
        ref["decode"] = zr.decode_logits(tcfg, "fsdp_tp")["logits"]
        tok = np.random.default_rng(5).integers(0, tcfg.vocab_size, (4,))
        jl, _ = JT.decode_step(_jax_params(jcfg, tparams),
                               JT.init_cache(jcfg, 4, 16),
                               jnp.asarray(tok, jnp.int32), jnp.int32(0),
                               jcfg)
        ref["decode_jax"] = np.asarray(jl)
        out = zr.world_results(root, procs)
    finally:
        for pr in (pr for ps in (procs or {}).values() for pr in ps):
            if pr.is_alive():
                pr.kill()
    out["ref"] = ref
    return out


def _world_of(shape) -> int:
    return shape[0] * shape[1]


# ---------------------------------------------------------------------------
# the fault: MoE routing over the whole batch on a data mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [0, zr.ROUTE_MICRO])
@pytest.mark.parametrize("world", [2, 4])
def test_data_mesh_moe_step_matches_jax_global_step(worlds, world, mb):
    """TINY_MOE's train step on a ("data",) mesh of ``world`` ranks (each
    rank half or a quarter of the batch), on the whole batch and in
    global microbatches of 4 rows: loss, ce and every gradient equal JAX's
    one-device step on the global batch (whose routing drops tokens); the
    aux of the forward on a rank's rows is the global batch's."""
    got = worlds[world]["route"][f"mb{mb}"]
    want = worlds["ref"]["route"][mb]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], **TOL)
    np.testing.assert_allclose(float(got["ce"]), want["ce"], **TOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        _close(g.numpy(), want["grads"][k], msg=k)
    if mb == 0:
        np.testing.assert_allclose(float(worlds[world]["route"]["aux"]),
                                   worlds["ref"]["route"]["aux"], **TOL)


def test_local_routing_misses_the_global_step(worlds):
    """The witness of the fault: each rank's rows routed alone (what the
    port computed on a data mesh before: one process in microbatches of
    one rank's rows) is another function, by far more than the bars."""
    local = worlds["ref"]["route"]["local"]
    want = worlds["ref"]["route"][0]
    assert abs(float(local["loss"]) - want["loss"]) > 1e-4
    k = "segments/0/p1/moe/router/kernel"
    assert not np.allclose(local["grads"][k].numpy(), want["grads"][k],
                           rtol=1e-2)
    one = worlds["ref"]["route"]["port_one"]["mb0"]
    np.testing.assert_allclose(float(one["loss"]), want["loss"], **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_moe_expert_blocks_match_jax(dtype, n):
    """``_local_moe`` on each of ``n`` expert blocks (``tp_index``,
    ``tp_size``) against JAX's on the same values, with drops: the block's
    partial output and the aux (fp32 rtol 1e-5; bf16 products and the
    bf16 combine part by an ulp now and then: 1e-2 of max |out|), and the
    blocks' sum is the whole function's."""
    cfg = zr.tiny_cfg(zr.TINY_MOE)
    jcfg = _jax_cfg(zr.TINY_MOE)
    dt = getattr(torch, dtype)
    p, x, _ = zr.moe_inputs(dt)
    e_loc = cfg.n_experts // n
    total = 0
    for i in range(n):
        blk = [p[f"experts/{w}"][i * e_loc:(i + 1) * e_loc]
               for w in ("wg", "wu", "wd")]
        out, aux = TM._local_moe(x, p["router/kernel"], *blk, cfg=cfg,
                                 tp_index=i, tp_size=n)
        jout, jaux = JM._local_moe(
            jnp.asarray(x.float().numpy()).astype(dtype),
            jnp.asarray(p["router/kernel"].float().numpy()).astype(dtype),
            *(jnp.asarray(b.float().numpy()).astype(dtype) for b in blk),
            cfg=jcfg, tp_index=i, tp_size=n)
        jout = np.asarray(jout.astype(jnp.float32))
        if dtype == "float32":
            _close(out.numpy(), jout, rtol=1e-5, msg=f"block {i}")
        else:
            assert np.abs(out.float().numpy() - jout).max() <= \
                1e-2 * np.abs(jout).max(), i
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        total = total + out.float()
    whole, _ = TM._local_moe(x, p["router/kernel"], p["experts/wg"],
                             p["experts/wu"], p["experts/wd"], cfg=cfg)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert (total - whole.float()).abs().max() <= \
        tol * whole.float().abs().max()


# ---------------------------------------------------------------------------
# expert parallelism over model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_ep_moe_ffn_matches_one_process_and_jax(worlds, shape):
    """``moe_ffn`` on whole inputs on a (data, model) mesh: each rank runs
    E/model experts of its data shard's rows; the output, the aux and every
    gradient (x, router, experts, shared experts) equal one process
    routing each data shard alone and JAX's function of the same, and are
    the same bits on every rank."""
    got = worlds[_world_of(shape)][f"ep/{zr.mesh_key(shape)}"]
    assert bool(got["ranks_equal"])
    port, jx = worlds["ref"]["moe"][shape[0]]
    for want in (port["out"].numpy(), jx["out"]):
        _close(got["out"].numpy(), want, rtol=1e-5)
    for want in (float(port["aux"]), jx["aux"]):
        np.testing.assert_allclose(float(got["aux"]), want, **TOL)
    assert set(got["grads"]) == set(port["grads"]) == set(jx["grads"])
    for k, g in got["grads"].items():
        _close(g.numpy(), port["grads"][k].numpy(), msg=f"port {k}")
        _close(g.numpy(), jx["grads"][k], msg=f"jax {k}")


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_ep_step_gradient_matches_jax(worlds, shape):
    """TINY_MOE's train step (drops) with the batch cut over the data
    axes and the experts over ``model``: loss and every gradient equal
    JAX's one-device step routing one data shard at a time (its
    microbatches of one shard's rows), and every model rank ends with the
    same whole gradients."""
    got = worlds[_world_of(shape)][f"ep_grads/{zr.mesh_key(shape)}"]
    assert bool(got["ranks_equal"])
    want = worlds["ref"]["route"][f"ep{shape[0]}"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], **TOL)
    for k, g in got["grads"].items():
        _close(g.numpy(), want["grads"][k], msg=k)


@pytest.mark.parametrize("zero_mode", ["off", "1"])
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_ep_dct_adamw_step_matches_one_process(worlds, shape, zero_mode):
    """deepseek-moe-16b's smoke model, two DCT-AdamW steps (int8 EF) with
    the state held as ``fsdp_tp`` blocks and the experts run
    expert-parallel: one process running one data shard's rows a
    microbatch. The backward sums the model ranks' partial gradients of x
    and of the gates in another order than one process: the losses are
    held at rtol 1e-6, parameters and moments at 1e-3 of their largest
    entry (measured 2.9e-4: Adam's first steps move the few elements whose
    gradient is near zero), the selections equal, the EF in value."""
    got = worlds[_world_of(shape)][
        f"ep_step/{zr.mesh_key(shape)}/{zero_mode}"]
    mb = zr.batch_rows(shape, "fsdp_tp")
    want = worlds["ref"]["ep_step"][0 if mb == zr.TRAIN["batch"] else mb]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for k, v in want["params"].items():
        _close(got["params"][k], v, rtol=1e-3, msg=k)
    for k, v in want["opt_state"].items():
        if not v.is_floating_point():       # selections, EF codes, steps
            if "||.ef||" not in k:
                assert torch.equal(got["opt_state"][k], v), k
        elif "||.ef||" not in k:
            _close(got["opt_state"][k], v, rtol=1e-3, msg=k)
    # the int8 EF in value: where the residual it quantizes moved by
    # rounding a code moves by a step or two of 127 (3e-2 of its largest
    # entry; measured below 1.6e-2), and where every column is selected it
    # holds rounding noise (1e-4 of the leaf's first moment, as
    # test_torch_zero.py holds it)
    for k in (k for k in want["opt_state"] if k.endswith("||.ef||.q")):
        leaf = k[:-len("||.ef||.q")]
        deq = [t[k].float() * t[leaf + "||.ef||.scale"]
               for t in (got["opt_state"], want["opt_state"])]
        bar = max(3e-2 * float(deq[1].abs().max()), 1e-4 * float(
            want["opt_state"][leaf + "||.m"].abs().max()))
        assert float((deq[0] - deq[1]).abs().max()) <= bar, k


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_decode_tp_decode_with_f_cut_experts(worlds, shape):
    """The reference's own check (``tests/test_multidevice.py``): a tiny
    MoE's ``decode_step`` under ``decode_tp`` (experts over ``model``,
    their hidden dim over the data axes, the f-partials summed) against
    ``fsdp_tp``, one process and JAX's, at its bar."""
    res = worlds[_world_of(shape)]
    one, jx = worlds["ref"]["decode"], worlds["ref"]["decode_jax"]
    for layout in ("fsdp_tp", "decode_tp"):
        got = res[f"decode/{zr.mesh_key(shape)}/tinymoe/{layout}"]["logits"]
        for want in (one.numpy(), jx):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=1e-4, err_msg=layout)


# ---------------------------------------------------------------------------
# sequence-parallel attention over model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(zr.SP_CASES))
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_sp_attention_matches_jax(worlds, shape, case):
    """``sp_blockwise_attention`` on whole inputs at S = 128 (64 query rows
    a model rank at tp 2: the reference's S/tp >= 64): the reference's
    heads (6 / 3 of 16, neither divides tp) causal and windowed, an
    MLA-shaped case (v dim 16 beside qk 24) and a cross-attention (40 keys,
    no mask); output and dq / dk / dv against JAX's ``blockwise_attention``
    and the port's on one process, the same bits on every rank."""
    got = worlds[_world_of(shape)][f"sp/{zr.mesh_key(shape)}/{case}"]
    assert bool(got["ranks_equal"])
    port, jx = worlds["ref"]["sp"][case]
    for want in (port["out"].numpy(), jx["out"]):
        np.testing.assert_allclose(got["out"].numpy(), want, atol=3e-5,
                                   rtol=0)
    for k in "qkv":
        _close(got["grads"][k].numpy(), port["grads"][k].numpy(),
               rtol=1e-5, msg=f"port d{k}")
        _close(got["grads"][k].numpy(), jx["grads"][k], msg=f"jax d{k}")


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_sp_train_step_loss_parity(worlds, shape):
    """A tiny dense model's train step with ``attn_sp`` on and off on the
    mesh: losses within the reference's 1e-4, the gradients at the
    gradient bar, whole and equal on every rank."""
    res = worlds[_world_of(shape)]
    off, on = (res[f"sp_step/{zr.mesh_key(shape)}/{v}"]
               for v in (False, True))
    assert bool(on["ranks_equal"]) and bool(off["ranks_equal"])
    assert abs(float(on["loss"]) - float(off["loss"])) < 1e-4
    for k, g in on["grads"].items():
        _close(g.numpy(), off["grads"][k].numpy(), msg=k)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_sp_prefill_hands_each_rank_its_offset(worlds, shape):
    """With the route's device test patched to say "card" and recorders in
    place of the launchers, a no-grad SP prefill (windowed, S = 128) hands
    model rank i's 64 rows to the bf16 and the fp32 kernel at q_offset
    64 i; the outputs equal the plain loop's on the whole sequence."""
    got = worlds[_world_of(shape)][f"sp_route/{zr.mesh_key(shape)}"]
    tp = shape[1]
    rows = zr.SP_SEQ // tp
    want = torch.tensor([[[0, rows, i * rows], [1, rows, i * rows]]
                         for i in range(tp)])
    assert torch.equal(got["calls"], want), got["calls"]
    q, k, v, _, kw = zr.sp_inputs("window")
    ref16 = fa.blockwise_attention_ref(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), **kw, **zr.SP_CHUNKS)
    assert torch.equal(got["bf16"], ref16)
    np.testing.assert_allclose(got["fp32"].numpy(), fa.flash_attention_ref(
        q, k, v, **kw).numpy(), atol=3e-5, rtol=0)


def test_sp_slice_whose_keys_do_not_cover_it_raises(monkeypatch):
    """A shape no kernel takes still raises on the card's route: a masked
    query slice at an offset whose keys end before its last row."""
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    q, k, v, _, kw = zr.sp_inputs("causal")
    with torch.inference_mode(), pytest.raises(ValueError, match="no kernel"):
        TL.blockwise_attention(q[:, 64:].bfloat16(), k[:, :100].bfloat16(),
                               v[:, :100].bfloat16(), q_offset=64, **kw,
                               **zr.SP_CHUNKS)
