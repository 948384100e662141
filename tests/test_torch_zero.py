"""ZeRO-1 of the port (``repro_torch.parallel``) against its own replicated
path and the JAX package's replicated update.

The gates mirror the reference's: config validation, each rule's
``zero_shardable``, the training CLI's two refusals (the reference's
messages), ``resolve`` giving None without a mesh or at one shard, and the
placements against ``repro.parallel.zero`` / ``repro.parallel.sharding``
on the same trees under each layout, as PartitionSpec tuples.

Then two spawned worlds on ``gloo`` (``tests/torch_zero_ranks.py``): 2
ranks over ``("data",)`` and 4 over ``("pod", "data")`` = (2, 2), started
once for the module while this process computes the replicated runs.
They run the reference's case set (``tests/test_zero_parity.py``) on its
leaves, with the (38, 20) leaf eligible at 2 ranks and not at 4: every
case, 6 steps, each step's gathered update and the last gathered state
held to the port's replicated run (rtol 1e-6; the selected indices equal)
and the first 3 updates to the JAX package's replicated ones at the parity
tolerance of ``test_torch_optim.py`` (rtol 1e-4, atol 1e-4 of max |u|);
telemetry; a checkpoint saved at 4 ranks and restored at 2 and at 1; and
a smoke-size llama train step at 2 ranks against the step on the whole
batch. Gradients are planted (``torch_zero_ranks.planted``), so every
top-r cut has a clear margin.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zero_ranks as zr
from torch_threads import one_torch_thread  # noqa: F401 - autouse
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.parallel import sharding as jsh
from repro.parallel import zero as jzero
from repro.telemetry.stats import collect as jax_collect
from repro_torch.optim.api import get_optimizer
from repro_torch.parallel import sharding, zero
from repro_torch.telemetry.stats import collect
from repro_torch.train.checkpoint import CheckpointManager

WORLDS = zr.WORLDS


def _close(got, want, rtol=1e-4, msg=""):
    """rtol, and atol rtol of the largest entry (entries that cancel)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
def test_zero_config_validation():
    for mod in (zero, jzero):
        with pytest.raises(ValueError) as e:
            mod.ZeroConfig(mode="2")
        assert mod.ZeroConfig(axes=["data"]).axes == ("data",)
        assert not mod.ZERO_OFF.active and mod.parse_zero("1").active
        assert mod.ZERO_MODES == ("off", "1")
    with pytest.raises(ValueError) as je:
        jzero.ZeroConfig(mode="2")
    assert str(e.value) == str(je.value)
    with pytest.raises(TypeError, match="ZeroConfig"):
        get_optimizer("dct_adamw", lr=0.01, zero=("data",))


def _rules(mod_pa, mod_mu, mod_tr, mod_di):
    rules = {f"{p}-{res}": mod_pa.ProjectedAdamRule(projector=p, residual=res)
             for p in ("dct", "dst", "hadamard", "randortho", "randperm",
                       "svd", "power", "random")
             for res in ("ef", "discard", "sign", "fira")}
    rules.update(muon=mod_mu.MuonRule(), muon_rank=mod_mu.MuonRule(rank=8),
                 trion=mod_tr.TrionRule(), dion=mod_di.DionRule())
    return rules


def test_zero_shardable_gate():
    """Each rule's ``zero_shardable`` equals the reference's (the ``optim``
    packages export functions named as the modules: import by path)."""
    def mods(pkg):
        return [importlib.import_module(f"{pkg}.optim.{m}")
                for m in ("projected_adam", "muon", "trion", "dion")]

    port, ref = _rules(*mods("repro_torch")), _rules(*mods("repro"))
    assert {k: r.zero_shardable for k, r in port.items()} == \
        {k: r.zero_shardable for k, r in ref.items()}
    assert port["dct-ef"].zero_shardable and not port["dct-fira"].zero_shardable


@pytest.mark.parametrize("argv", [
    ["--optimizer", "ldadamw", "--zero", "1"],
    ["--optimizer", "dct_adamw", "--zero", "1", "--adaptive-rank"]])
def test_cli_zero_refusals(argv):
    """Both refusals, with the reference's messages."""
    from repro.launch import train as jax_cli
    from repro_torch.launch import train as train_cli

    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen2.5-32b", "--smoke", "--device", "cpu",
                        "--steps", "1", *argv])
    with pytest.raises(SystemExit) as je:
        jax_cli.main(["--arch", "qwen2.5-32b", "--smoke", "--steps", "1",
                      *argv])
    assert str(e.value) == str(je.value) and str(e.value).startswith("--zero")
    assert "--zero" not in train_cli.NOT_YET_PORTED
    assert train_cli.ZERO_ALWAYS == jax_cli.ZERO_ALWAYS


@pytest.mark.parametrize("world,local,cards,refused", [
    (8, 8, 4, True),     # one node, more ranks than cards
    (8, 1, 1, False),    # 8 nodes of one card each
    (8, 4, 4, False)])   # 2 nodes of 4 cards
def test_nccl_needs_a_card_for_each_local_rank(monkeypatch, world, local,
                                               cards, refused):
    """``--dist-backend nccl`` counts this node's ranks (torchrun's
    ``LOCAL_WORLD_SIZE``) against this node's cards, never the world."""
    import argparse

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli

    inits = []
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(train_cli.dist, "init_process_group", inits.append)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda shape, axes: (shape, axes))
    args = argparse.Namespace(dist_backend=None)
    if refused:
        with pytest.raises(SystemExit, match="dist-backend gloo"):
            train_cli._data_parallel(args, torch.device("cuda"), world)
        assert inits == []
    else:
        assert train_cli._data_parallel(args, torch.device("cuda"), world) \
            == ((world,), ("data",))
        assert inits == ["nccl"]


def test_resolve_inactive(tmp_path):
    """None without a config, off, without a mesh, without the axes, and
    at one shard."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    on = zero.ZeroConfig("1")
    assert zero.resolve(None) is None and zero.resolve(zero.ZERO_OFF) is None
    assert zero.resolve(on) is None and sharding.dp_axes() == ()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        with sharding.set_mesh(mesh):
            assert sharding.active_mesh() is mesh
            assert sharding.dp_axes() == ("data",)
            assert sharding.tp_axis() is None
            assert zero.resolve(on) is None
            assert zero.resolve(zero.ZeroConfig("1", axes=("model",))) is None
        assert sharding.active_mesh() is None
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """Axis names and sizes: all that placement derivation reads."""

    sizes: tuple = (("pod", 2), ("data", 4))

    @property
    def axis_names(self):
        return tuple(n for n, _ in self.sizes)

    @property
    def shape(self):
        return dict(self.sizes)


def _spec_tuples(tree, kind) -> dict:
    """``{field path: node}`` of the ``kind`` nodes of a per-leaf tree."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, kind):
            out[path] = node
        elif hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, f"{path}.{f}")
    walk(tree, "")
    return out


@pytest.mark.parametrize("layout", sharding.LAYOUTS)
@pytest.mark.parametrize("name,kw", [
    ("dct_adamw", dict(rank=8)), ("dct_adamw", dict(rank=8, ef_dtype="fp32")),
    ("muon", dict(rank=16)), ("trion", dict(rank=16)),
    ("dion", dict(rank=16)), ("galore", dict(rank=8, projector="dct"))],
    ids=["dct_adamw", "dct_adamw-fp32ef", "muon", "trion", "dion", "galore"])
def test_placements_match_reference(name, kw, layout):
    """``opt_state_specs(zero=)`` of the port (on the state it holds whole,
    and on one rank's blocks of it) against the reference's under each
    layout, every array of every matrix leaf, as PartitionSpec tuples;
    ``eligible`` and ``grad_spec`` beside."""
    from jax.sharding import PartitionSpec as P

    mesh, cfg = FakeMesh(), zero.ZeroConfig("1")
    shapes = dict(zr.SHAPES, bad=(36, 20))          # 36 % 8: ineligible
    jparams = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jopt = jax_get_optimizer(name, lr=0.01, **kw)
    jstate = jax.eval_shape(jopt.init, jparams)
    with jsh.use_policy(layout=layout):
        jspecs = jsh.opt_state_specs(jstate, jparams,
                                     jsh.params_specs(jparams, mesh),
                                     zero=jzero.ZeroConfig("1"), mesh=mesh)
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    state = get_optimizer(name, lr=0.01, **kw).init(params)
    with sharding.use_policy(layout=layout):
        specs = sharding.opt_state_specs(
            state, params, sharding.params_specs(params, mesh), zero=cfg,
            mesh=mesh)
    for path in ("w", "odd", "wide", "bad"):
        want = {f: tuple(p) if any(x is not None for x in p) else ()
                for f, p in _spec_tuples(jspecs.leaves[0]["lowrank"][path],
                                         P).items()}
        leaf = state.leaves[0]["lowrank"][path]
        arrays = dict(_spec_tuples(leaf, torch.Tensor))
        got = {f: p.spec(arrays[f].dim() if f in arrays else 0)
               for f, p in _spec_tuples(specs.leaves[0]["lowrank"][path],
                                        sharding.Placement).items()}
        assert got == want, (path, got, want)
        assert zero.eligible(shapes[path], 8) == \
            jzero.eligible(shapes[path], 8)
        assert zero.grad_spec(shapes[path], ("pod", "data")).spec(
            len(shapes[path])) == tuple(jzero.grad_spec(shapes[path],
                                                        ("pod", "data")))
        # one rank's block of the moments places as the whole moments do
        if zero.partitioned(leaf, shapes[path], 8):
            block = leaf._replace(m=leaf.m[..., :leaf.m.shape[-2] // 8, :])
            assert zero.state_specs(shapes[path], block, ("pod", "data"),
                                    8).m == specs.leaves[0]["lowrank"][path].m


# ---------------------------------------------------------------------------
# the spawned worlds
# ---------------------------------------------------------------------------
# steps held to JAX, as the port's parity tests hold them
# (``test_torch_optim.py``): past them, q8 EF codes that sit on a rounding
# boundary flip between the two packages' fp32 sums and carry on
JAX_STEPS = 3


def _jax_case(name, kw, steps=JAX_STEPS):
    """JAX's replicated run of a case without Pallas in interpret mode:
    on its reference path (``fused="off"``, the function of "on" / "fft",
    which ``test_torch_fused_step.py`` holds), Dion's on "fft" (its "off"
    is QR in place of NS). Eager, as the port's parity tests hold it
    (under jit XLA's q8 scale is an ulp off IEEE), but FIRA's: it has no
    EF, and its refresh interval makes every eager call trace both
    branches of a ``lax.cond``."""
    kw = dict(kw, fused="fft" if name == "dion" else "off")
    opt = jax_get_optimizer(name, lr=0.01, **kw)
    update = jax.jit(opt.update) if name == "fira" else opt.update
    params = {k: jnp.zeros(s, jnp.float32) for k, s in zr.SHAPES.items()}
    st, ups = opt.init(params), []
    for t in range(steps):
        g = jax.tree.map(jnp.asarray, zr.grads_np(t, zr.case_rank(kw)))
        u, st = update(g, st, params)
        ups.append({k: np.asarray(v) for k, v in u.items()})
    return ups


def _stats_run(get, coll, name, kw, to_np, params):
    opt = get(name, lr=0.01, **kw)
    st, out = opt.init(params), []
    for t in range(zr.TELEMETRY_STEPS):
        g = {k: to_np(v) for k, v in zr.grads_np(t, zr.case_rank(kw)).items()}
        with coll() as col:
            _, st = opt.update(g, st, params)
        out.append({f"{p}/{f}": np.asarray(getattr(s, f))
                    for p, s in col.tree().items() for f in s._fields})
    return out


def _cli_argv(ckpt: str, steps: int) -> list:
    return ["--smoke", "--device", "cpu", "--optimizer", "dct_adamw",
            "--steps", str(steps), "--batch", str(zr.TRAIN["batch"]),
            "--seq-len", str(zr.TRAIN["seq"]), "--log-every", "1",
            "--ckpt-dir", ckpt, "--ckpt-every", str(CLI_STEPS)]


CLI_STEPS = 2


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results (spawned once a run, shared with
    ``test_torch_mesh_models.py``: ``zr.start_worlds``), the port's
    replicated runs and JAX's, and the training CLI under torchrun at 2
    ranks (``--standalone``: its rendezvous port is the system's pick), all
    started at once."""
    root = zr.worlds_root(tmp_path_factory)
    procs = zr.start_worlds(root)
    tmp = tempfile.mkdtemp(prefix="zero_cli_")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *_cli_argv(os.path.join(tmp, "cli_ckpt"), CLI_STEPS), "--zero", "1",
         "--dist-backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        ref = {"port": {}, "jax": {}, "port_stats": {}, "jax_stats": {}}
        for cid, (name, kw) in zr.CASES.items():
            ref["port"][cid] = zr.run_case(name, kw)
            ref["jax"][cid] = _jax_case(name, kw)
        jparams = {k: jnp.zeros(s, jnp.float32) for k, s in zr.SHAPES.items()}
        for cid, (name, kw) in zr.TELEMETRY.items():
            ref["port_stats"][cid] = _stats_run(
                get_optimizer, collect, name, kw, torch.from_numpy,
                zr.params_t())
            ref["jax_stats"][cid] = _stats_run(
                jax_get_optimizer, jax_collect, name, kw, jnp.asarray,
                jparams)
        ref["train"] = zr.train_run(None)
        ref["mesh"] = _mesh_references()
        out = zr.world_results(root, procs)
        out["cli"] = (*cli.communicate(timeout=300), cli.returncode)
    finally:
        for p in (p for ps in (procs or {}).values() for p in ps):
            if p.is_alive():
                p.kill()
        if cli.poll() is None:
            cli.kill()
    out["ref"] = ref
    out["ckpt"] = os.path.join(root, "ckpt")
    out["cli_ckpt"] = os.path.join(tmp, "cli_ckpt")
    return out


def _mesh_references() -> dict:
    """The one-process witnesses of the (data, model) mesh runs: the
    smoke llama's steps in microbatches of one rank's rows and the decode
    logits."""
    out = {}
    for shape in (s for ss in zr.MESHES.values() for s in ss):
        for layout in ("fsdp_tp", "pure_dp"):
            mb = zr.batch_rows(shape, layout)
            mb = 0 if mb == zr.TRAIN["batch"] else mb
            for opt_name in zr.MESH_OPTS:
                if (opt_name, mb) not in out:
                    out[opt_name, mb] = zr.run_record(
                        zr.placed_run(opt_name, "off", microbatch=mb))
    for arch in zr.DECODE_ARCHS:
        out["decode", arch] = zr.decode_logits(arch, "fsdp_tp")["logits"]
    out["clip"] = zr.clipped_adam_updates()
    return out


MESH_SHAPES = [s for ss in zr.MESHES.values() for s in ss]


def _world_of(shape) -> int:
    return shape[0] * shape[1]


def _assert_equal_runs(got, want, what):
    """Losses, parameters and optimizer state bit for bit."""
    assert torch.equal(got["losses"], want["losses"]), \
        (what, got["losses"], want["losses"])
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), (what, k)
    assert set(got["opt_state"]) == set(want["opt_state"])
    for k, v in want["opt_state"].items():
        assert torch.equal(got["opt_state"][k], v), (what, k)


@pytest.mark.parametrize("zero_mode", ["off", "1"])
@pytest.mark.parametrize("opt_name", list(zr.MESH_OPTS))
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_placed_train_step_matches_one_process(worlds, shape, opt_name,
                                               zero_mode):
    """The smoke llama's train step with the state held as ``fsdp_tp``
    blocks on a (data, model) mesh against one process running one rank's
    rows a microbatch (``zr.assert_clipped_runs``: without a model axis
    the first step's loss and gradients before the clip bit for bit, with
    one Megatron's products at the reference's bars; each clip factor
    within ``zr.CLIP_ULPS``; the runs' losses, gathered parameters and
    gathered optimizer state at its bars, selections equal); every split
    parameter leaf held as whole / blocks, every matrix and embedding
    split, less state held than whole."""
    got = worlds[_world_of(shape)][
        f"mesh/{zr.mesh_key(shape)}/{opt_name}/{zero_mode}/fsdp_tp"]
    mb = zr.batch_rows(shape, "fsdp_tp")
    want = worlds["ref"]["mesh"][opt_name,
                                 0 if mb == zr.TRAIN["batch"] else mb]
    zr.assert_clipped_runs(got, want, (shape, opt_name, zero_mode),
                           megatron=shape[1] > 1)
    split = set()
    for k, (held, whole, n) in got["param_bytes"].items():
        assert held * n == whole, (k, held, whole, n)
        if n > 1:
            split.add(k)
    assert split == {k for k, v in got["params"].items() if v.dim() >= 2
                     and "ln" not in k}, split
    held, whole = got["opt_bytes"].tolist()
    assert held < whole, (held, whole)


@pytest.mark.parametrize("zero_mode", ["off", "1"])
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_pure_dp_matches_fsdp_tp(worlds, shape, zero_mode):
    """``pure_dp`` (parameters replicated, the batch over every axis)
    against ``fsdp_tp`` and against its one-process witness. Bit for bit
    where the gradients average two shares (against ``fsdp_tp``, whose
    clip sums the blocks: ``zr.assert_clipped_runs``). At (2, 2) pure_dp
    averages four in gloo's order and the witness accumulates them in turn: the
    gradients part by rounding, which Adam's first steps turn into moves
    of up to ~lr on the few elements whose gradient is near zero (2 of
    65536 at 4.5e-6), so the parameters are held at 1e-3 of their
    largest entry there."""
    key = zr.mesh_key(shape)
    res = worlds[_world_of(shape)]
    pure = res[f"mesh/{key}/dct_adamw/{zero_mode}/pure_dp"]
    fsdp = res[f"mesh/{key}/dct_adamw/{zero_mode}/fsdp_tp"]
    assert all(n == 1 for _, _, n in pure["param_bytes"].values())
    mb = zr.batch_rows(shape, "pure_dp")
    want = worlds["ref"]["mesh"]["dct_adamw", 0 if mb == zr.TRAIN["batch"]
                                 else mb]
    if shape[0] * shape[1] == 2:
        _assert_equal_runs(pure, want, (shape, "pure_dp"))
    else:
        np.testing.assert_allclose(pure["losses"], want["losses"],
                                   rtol=1e-6)
        for k, v in want["params"].items():
            _close(pure["params"][k], v, rtol=1e-3, msg=k)
    if zr.batch_rows(shape, "pure_dp") == zr.batch_rows(shape, "fsdp_tp"):
        zr.assert_clipped_runs(fsdp, pure, (shape, "fsdp_tp vs pure_dp"),
                               megatron=shape[1] > 1)
    np.testing.assert_allclose(pure["losses"], fsdp["losses"], rtol=1e-5)


@pytest.mark.parametrize("arch", zr.DECODE_ARCHS)
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_decode_tp_logits(worlds, shape, arch):
    """Parameters placed under ``decode_tp`` (every matrix over all the
    mesh axes) and under ``fsdp_tp``, gathered, and ``decode_step`` run
    under the layout: the logits equal one process's bit for bit, except
    where ``decode_tp`` cuts the MoE experts' hidden dim over a data axis
    of 2 and sums the f-partials (the reference's bar there, ``tests/
    test_multidevice.py``: atol 2e-5, rtol 1e-4); each rank holds a share
    of the bytes."""
    res = worlds[_world_of(shape)]
    want = worlds["ref"]["mesh"]["decode", arch]
    for layout in ("fsdp_tp", "decode_tp"):
        got = res[f"mesh/{zr.mesh_key(shape)}/decode/{arch}/{layout}"]
        if layout == "decode_tp" and shape[0] > 1 and arch in zr.MOE_ARCHS:
            # the experts' hidden dim cut over data: the f-partials are
            # summed there, in another order; the reference's own bar
            np.testing.assert_allclose(got["logits"], want, atol=2e-5,
                                       rtol=1e-4)
        else:
            assert torch.equal(got["logits"], want), layout
        held, whole = got["bytes"].tolist()
        assert held < whole, (layout, held, whole)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=zr.mesh_key)
def test_clip_sums_the_blocks(worlds, shape):
    """Full-rank Adam with its moments held as blocks, then
    ``clip_global_norm``: the norm sums every rank's blocks, so the
    gathered updates are one process's (the shards' squares summed in
    another order: rtol 1e-6)."""
    got = worlds[_world_of(shape)][f"mesh/{zr.mesh_key(shape)}/clip"]
    for t, want in enumerate(worlds["ref"]["mesh"]["clip"]):
        for k, v in want.items():
            _close(got[t][k], v, rtol=1e-6, msg=f"step {t} {k}")


@pytest.mark.parametrize("at", ["1x2", "1"])
def test_placed_checkpoint_reshards(worlds, at):
    """The placed state saved whole at (2, 2) after two steps, restored
    at (1, 2) and at one process: the restored state is the saved one bit
    for bit, and one more step from it at (1, 2) (Megatron's products) and
    at one process agree at ``zr.assert_clipped_runs``' Megatron bars
    (the (2, 2) run's own steps are held to one process by
    ``test_placed_train_step_matches_one_process``)."""
    saved = worlds[4]["mesh/ckpt_saved"]
    target = zr.placed_run(zr.MESH_CKPT[0], "off", steps=0)
    st = CheckpointManager(os.path.join(os.path.dirname(worlds["ckpt"]),
                                        "mesh_ckpt")).restore(
        zr.MESH_STEPS, target["whole"])
    one = zr.run_record(zr.placed_run(zr.MESH_CKPT[0], "off", steps=1,
                                      state=st, start=zr.MESH_STEPS))
    mesh = worlds[2]["mesh/restore"]
    if at == "1x2":
        restored, nxt, want = mesh["restored"], mesh["next"], one
    else:
        restored, nxt, want = zr.flat_tensors(st), one, mesh["next"]
    assert set(restored) == set(saved)
    for k, v in saved.items():
        assert torch.equal(restored[k], v), k
    zr.assert_clipped_runs(nxt, want, f"restored at {at}", megatron=True)


@pytest.mark.parametrize("cid", list(zr.CASES))
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_update_matches_replicated(worlds, world, cid):
    name, kw = zr.CASES[cid]
    got = worlds[world][f"case/{cid}"]
    ups, state, _ = worlds["ref"]["port"][cid]
    want_state = zr.flat_tensors(state)
    held, whole = got["held"].tolist()
    assert held < whole, (held, whole)      # the world held blocks
    for t in range(zr.STEPS):
        for k in zr.SHAPES:
            _close(got["updates"][t][k], ups[t][k], rtol=1e-6,
                   msg=f"port step {t} {k}")
            if t < JAX_STEPS:
                _close(got["updates"][t][k],
                       worlds["ref"]["jax"][cid][t][k],
                       msg=f"jax step {t} {k}")
    assert set(got["state"]) == set(want_state)
    for key, v in want_state.items():
        if v.is_floating_point():
            _close(got["state"][key], v, rtol=1e-6, msg=key)
        else:                               # indices, EF codes, steps
            assert torch.equal(got["state"][key], v), key


@pytest.mark.parametrize("cid", list(zr.TELEMETRY))
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_telemetry_matches_replicated(worlds, world, cid):
    got = worlds[world][f"telemetry/{cid}"]
    for t in range(zr.TELEMETRY_STEPS):
        want, jwant = (worlds["ref"][k][cid][t]
                       for k in ("port_stats", "jax_stats"))
        assert set(got[t]) == set(want) == set(jwant) and want
        for key, v in want.items():
            np.testing.assert_allclose(got[t][key].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{t} {key}")
            np.testing.assert_allclose(got[t][key].numpy(), jwant[key],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"jax {t} {key}")


@pytest.mark.parametrize("world", [2, 1])
def test_checkpoint_reshards(worlds, world):
    """Saved whole at 4 ranks, restored at ``world``: one more update equals
    the replicated run's; at one rank the restored state is the 4 ranks'
    gathered blocks bit for bit."""
    name, kw = zr.CASES[zr.CKPT_CASE]
    ups, _, _ = zr.run_case(name, kw, zr.CKPT_STEP + 1)
    if world == 2:
        u = worlds[2]["ckpt/update"]
        assert int(worlds[2]["ckpt/held_rows"]) == zr.SHAPES["w"][1] // 2
    else:
        opt = get_optimizer(name, lr=0.01, **kw)
        params = zr.params_t()
        st = CheckpointManager(worlds["ckpt"]).restore(zr.CKPT_STEP,
                                                       opt.init(params))
        flat = zr.flat_tensors(st)
        saved = worlds[4]["ckpt/state"]
        assert set(flat) == set(saved)
        for key, v in saved.items():
            assert torch.equal(flat[key], v), key
        g = {k: torch.from_numpy(v) for k, v in
             zr.grads_np(zr.CKPT_STEP, zr.case_rank(kw)).items()}
        u, _ = opt.update(g, st, params)
    for k in zr.SHAPES:
        _close(u[k], ups[zr.CKPT_STEP][k], rtol=1e-6, msg=k)


def test_train_step_matches_whole_batch(worlds):
    """Two train steps of the smoke llama at 2 ranks (half the batch each,
    the loss and the gradients averaged) against the steps on the whole
    batch."""
    got = worlds[2]["train"]
    losses, params, opt_state = worlds["ref"]["train"]
    np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=1e-6)
    for k, p in params.items():
        _close(got["params"][k], p, msg=k)
    want, have = zr.flat_tensors(opt_state), got["opt_state"]
    for key, v in want.items():
        if "||.ef||" in key:
            continue
        if v.is_floating_point():
            _close(have[key], v, msg=key)
        else:
            assert torch.equal(have[key], v), key
    # at rank 128 = n the EF holds the fp32 rounding of G - G Q Q^T: noise
    # (scales ~1e-11), held in value to 1e-4 of the leaf's first moment
    for key in (k for k in want if k.endswith("||.ef||.q")):
        leaf = key[:-len("||.ef||.q")]
        deq = [t[key].float() * t[leaf + "||.ef||.scale"]
               for t in (have, want)]
        bar = 1e-4 * float(want[leaf + "||.m"].abs().max())
        assert float((deq[0] - deq[1]).abs().max()) <= bar, key


def test_cli_torchrun_zero(worlds):
    """``--zero 1`` through torchrun at 2 gloo ranks: each rank holds
    blocks of the parameters and of the state, the ranks' losses agree, step 1 equals the whole
    batch's step (``train_run``'s), rank 0 writes the whole checkpoint and
    a one-process run resumes from it."""
    from repro_torch.launch import train as train_cli

    stdout, stderr, rc = worlds["cli"]
    assert rc == 0, (stdout[-2000:], stderr[-4000:])
    ranks = [json.loads(line.split("[train] rank ", 1)[1])
             for line in stdout.splitlines()
             if line.startswith("[train] rank ")]
    assert sorted(r["rank"] for r in ranks) == [0, 1], stdout[-2000:]
    for r in ranks:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["opt_state_bytes"] < r["opt_state_whole_bytes"]
        assert r["param_bytes"] < r["param_whole_bytes"]
        assert r["losses"] == ranks[0]["losses"]
        assert len(r["losses"]) == CLI_STEPS
    np.testing.assert_allclose(ranks[0]["losses"][0],
                               worlds["ref"]["train"][0][0], rtol=1e-6)
    hist = train_cli.run(train_cli.build(_cli_argv(
        worlds["cli_ckpt"], CLI_STEPS + 1))).metrics_history
    assert [h["step"] for h in hist] == [CLI_STEPS + 1]
    assert np.isfinite(hist[0]["loss"])


def test_cli_torchrun_equals_microbatched_run(worlds, monkeypatch, tmp_path):
    """The 2 ranks' first loss equals bit for bit that of one process that
    runs the same configuration in microbatches of one rank's rows (the
    ranks' averaged gradients are its accumulated ones: g0 / 2 + g1 / 2 ==
    (g0 + g1) / 2 in fp32, and the row-block update is the replicated
    one); the later ones follow a clip factor from the blocks' sums, a few
    ulps off, within ``zr.LATER_LOSS_RTOL``."""
    from repro_torch.configs import registry
    from repro_torch.launch import train as train_cli

    stdout, stderr, rc = worlds["cli"]
    assert rc == 0, (stdout[-2000:], stderr[-4000:])
    rank0 = next(r for r in (json.loads(line.split("[train] rank ", 1)[1])
                             for line in stdout.splitlines()
                             if line.startswith("[train] rank "))
                 if r["rank"] == 0)
    cfg = registry.SMOKES["llama-350m"]
    monkeypatch.setitem(registry.SMOKES, "llama-350m", dataclasses.replace(
        cfg, train_microbatch=zr.TRAIN["batch"] // 2))
    hist = train_cli.run(train_cli.build(_cli_argv(
        str(tmp_path / "ckpt"), CLI_STEPS))).metrics_history
    losses = [h["loss"] for h in hist]
    # step 1 before any update; the clip's norm sums the blocks (a factor
    # a few ulps off), so the later steps at the runs' bar
    assert losses[0] == rank0["losses"][0], (losses, rank0["losses"])
    np.testing.assert_allclose(losses, rank0["losses"],
                               rtol=zr.LATER_LOSS_RTOL)
