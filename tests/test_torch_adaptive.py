"""The closed-loop controllers of the port against the JAX package's: the
rank allocator and the refresh scheduler on the same streams of summaries,
the leaf inventory, the state migration across a rebuild, the whole loop on
a tiny model, a resume after a rebuild, and the CLI's telemetry and
adaptive flags."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.telemetry import adaptive as jada
from repro.telemetry import controllers as jctl
from repro.train import steps as JS
from repro.train.loop import Trainer as JaxTrainer
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.optim.api import get_optimizer
from repro_torch.telemetry import adaptive as tada
from repro_torch.telemetry import controllers as tctl
from repro_torch.train import steps as TS
from repro_torch.train.checkpoint import tree_items
from repro_torch.train.loop import Trainer
from repro_torch.train.schedule import cosine_warmup

from test_torch_model_train import CFG, JAX_CFG
from test_torch_telemetry import _grads_np, _nest, _params_np

QUIET = lambda *a, **k: None  # noqa: E731

# leaves of several sizes; "small" has 16 columns, under the cap of the
# allocator's base rank 32 * 4
LEAVES = {"a": (64, 64), "b": (256, 64), "c": (64, 128), "small": (512, 16)}


def _stream(seed, steps, paths, sentinels=False):
    """Per-step per-leaf summaries: captured energy per leaf around its own
    level, overlaps with a -1 sentinel on alternate steps."""
    rng = np.random.default_rng(seed)
    level = {p: rng.uniform(0.1, 0.95) for p in paths}
    out = []
    for step in range(1, steps + 1):
        keep = sentinels and step % 2 == 0
        out.append({p: {"captured_energy": float(np.clip(
                            level[p] + 0.05 * rng.standard_normal(), 0, 1)),
                        "topr_margin": -1.0 if keep else float(rng.random()),
                        "index_overlap": -1.0 if keep else float(
                            rng.uniform(0.0, 1.0) ** 0.3)}
                    for p in paths})
    return out


@pytest.mark.parametrize("cfg_kw", [
    {"base_rank": 32, "decide_every": 2, "deadband": 0.0},
    {"base_rank": 32, "decide_every": 1, "deadband": 0.0, "max_step": 1},
    {"base_rank": 24, "decide_every": 3, "deadband": 0.05, "quantum": 4,
     "ema_decay": 0.5},
    {"base_rank": 32, "decide_every": 2, "min_rank": 16, "max_rank": 48}])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_allocator_matches_jax(cfg_kw, seed):
    leaves = {p: tctl.LeafInfo(rows=s[0], cols=s[1])
              for p, s in LEAVES.items()}
    jleaves = {p: jctl.LeafInfo(rows=s[0], cols=s[1])
               for p, s in LEAVES.items()}
    t = tctl.RankAllocator(tctl.RankAllocatorConfig(**cfg_kw), leaves)
    j = jctl.RankAllocator(jctl.RankAllocatorConfig(**cfg_kw), jleaves)
    assert t.alloc == j.alloc and t.budget == j.budget
    decisions = 0
    for step, summ in enumerate(_stream(seed, 30, LEAVES), 1):
        t.observe(step, summ)
        j.observe(step, summ)
        tp, jp = t.propose(step), j.propose(step)
        assert tp == jp, step
        decisions += tp is not None
        assert t.ema == j.ema
    assert t.state_dict() == j.state_dict()
    assert t.overrides() == j.overrides()
    assert sum(leaves[p].rows * r for p, r in t.alloc.items()) <= t.budget
    if cfg_kw.get("deadband") == 0.0:
        assert decisions >= 1
    # a round trip through JSON (the checkpoint manifest) restores it
    t2 = tctl.RankAllocator(tctl.RankAllocatorConfig(**cfg_kw), leaves)
    t2.load_state_dict(json.loads(json.dumps(t.state_dict())))
    assert t2.state_dict() == t.state_dict()


@pytest.mark.parametrize("cfg_kw", [
    {"decide_every": 1, "cooldown": 0},
    {"decide_every": 2, "cooldown": 4, "low_drift": 0.3, "high_drift": 0.6,
     "max_interval": 8},
    {"base_interval": 4, "decide_every": 3, "cooldown": 3, "ema_decay": 0.5}])
@pytest.mark.parametrize("sentinels", [False, True])
def test_refresh_scheduler_matches_jax(cfg_kw, sentinels):
    t = tctl.RefreshScheduler(tctl.RefreshSchedulerConfig(**cfg_kw), LEAVES)
    j = jctl.RefreshScheduler(jctl.RefreshSchedulerConfig(**cfg_kw), LEAVES)
    for step, summ in enumerate(_stream(3, 40, LEAVES, sentinels), 1):
        t.observe(step, summ)
        j.observe(step, summ)
        assert t.propose(step) == j.propose(step), step
        assert t.drift_ema == j.drift_ema
    assert t.state_dict() == j.state_dict()
    assert t.overrides() == j.overrides()
    t2 = tctl.RefreshScheduler(tctl.RefreshSchedulerConfig(**cfg_kw), LEAVES)
    t2.load_state_dict(json.loads(json.dumps(t.state_dict())))
    assert t2.state_dict() == t.state_dict()


def test_controllers_report_through_obs():
    """Adopted decisions count on the controller instruments and land on
    the tracer as ``controller/*`` instants, under the reference's names."""
    from repro_torch import obs
    leaves = {p: tctl.LeafInfo(rows=s[0], cols=s[1])
              for p, s in LEAVES.items()}
    obs.reset()
    obs.enable()
    try:
        alloc = tctl.RankAllocator(tctl.RankAllocatorConfig(
            base_rank=32, decide_every=1, deadband=0.0), leaves)
        sched = tctl.RefreshScheduler(tctl.RefreshSchedulerConfig(
            decide_every=1, cooldown=0), LEAVES)
        n_rank = n_sched = 0
        for step, summ in enumerate(_stream(0, 10, LEAVES), 1):
            alloc.observe(step, summ)
            sched.observe(step, summ)
            n_rank += alloc.propose(step) is not None
            n_sched += sched.propose(step) is not None
        snap = obs.registry().snapshot()
        names = [r["name"] for r in obs.tracer().records()]
    finally:
        obs.disable()
        obs.reset()
    assert n_rank >= 1 and n_sched >= 1
    series = {k: sum(v["series"].values()) for k, v in snap.items()
              if k.startswith("controller_")}
    assert series["controller_rank_reallocations_total"] == n_rank
    assert series["controller_interval_changes_total"] == n_sched
    assert series["controller_ranks_changed_total"] >= n_rank
    assert names.count("controller/rank_realloc") == n_rank
    assert names.count("controller/interval_change") == n_sched


def test_merge_overrides_matches_jax():
    maps = ({"a": {"rank": 16}}, {"a": {"update_interval": 4},
                                  "b": {"rank": 8}}, None, {"b": {"rank": 24}})
    assert tctl.merge_overrides(*maps) == jctl.merge_overrides(*maps)


@pytest.mark.parametrize("layers", [1, 3])
def test_leaf_inventory_matches_jax(layers):
    import dataclasses
    sched = ((("attn",), layers),)
    jcfg = dataclasses.replace(JAX_CFG, schedule=sched)
    tcfg = dataclasses.replace(CFG, schedule=sched)
    want = jctl.leaf_inventory(jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    for dev in ("cpu", "meta"):
        got = tctl.leaf_inventory(TT.init_params(tcfg, 0, dev))
        assert {p: (li.rows, li.cols) for p, li in got.items()} == \
            {p: (li.rows, li.cols) for p, li in want.items()}
    assert len(got) == 7 and all(li.cols <= li.rows for li in got.values())


# ---------------------------------------------------------------------------
# state migration
# ---------------------------------------------------------------------------
def _items(tree) -> dict:
    return {"||".join(map(str, p)): x for p, x in tree_items(tree)}


@pytest.mark.parametrize("ef_dtype", ["fp32", "q8"])
@pytest.mark.parametrize("lr_scale", [False, True])
def test_migrate_opt_state_matches_jax(ef_dtype, lr_scale):
    """Three JAX steps, then a rebuild that moves a/kernel to rank 12: the
    port migrates the converted state into its own fresh one, leaf by leaf
    as JAX's migration does; one more step under the new optimizer
    agrees."""
    kw = dict(rank=6, ef_dtype=ef_dtype, fused="fft", lr_scale=lr_scale)
    jopt = jax_get_optimizer("dct_adamw", lr=1e-3, **kw)
    params_np = _params_np()
    jparams = jax.tree.map(jnp.asarray, _nest(params_np))
    jstate = jopt.init(jparams)
    for step in range(1, 4):
        _, jstate = jax.jit(jopt.update)(
            jax.tree.map(jnp.asarray, _nest(_grads_np(step))), jstate, jparams)
    ov = {"a/kernel": {"rank": 12}}
    jnew = jax_get_optimizer("dct_adamw", lr=1e-3, overrides=ov, **kw)
    jmig = jctl.migrate_opt_state(jstate, jnew.init(jparams))

    tparams = {k: torch.from_numpy(v) for k, v in params_np.items()}
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    tnew = get_optimizer("dct_adamw", lr=1e-3, overrides=ov, **kw)
    tmig = tctl.migrate_opt_state(tstate, tnew.init(tparams))
    want = _items(convert.opt_state_from_jax(jax.tree.map(np.asarray, jmig),
                                             device="cpu"))
    got = _items(tmig)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k
    # what survived is the old state's own tensor, not a copy
    old, new = _lowrank(tstate), _lowrank(tmig)
    assert new["b/kernel"] is old["b/kernel"]
    assert new["a/kernel"].m.shape[-1] == 12
    assert new["a/kernel"].inner_step == 0
    assert not new["a/kernel"].m.any()
    for f_new, f_old in zip(_ef_tensors(new["a/kernel"].ef),
                            _ef_tensors(old["a/kernel"].ef)):
        assert f_new is f_old and f_old.abs().sum() > 0
    # the migrated state is usable: one more step in both
    g = _grads_np(9)
    ju, _ = jax.jit(jnew.update)(jax.tree.map(jnp.asarray, _nest(g)), jmig,
                                 jparams)
    tu, tmig2 = tnew.update({k: torch.from_numpy(v) for k, v in g.items()},
                            tmig, tparams)
    assert tmig2.step == 4
    ju = convert.params_from_jax(jax.tree.map(np.asarray, ju), device="cpu")
    for k, u in tu.items():
        np.testing.assert_allclose(u.numpy(), ju[k].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ju[k].abs().max()))


def _lowrank(state) -> dict:
    leaves = state.leaves
    if len(leaves) == 2:                 # (chain, InjectHyperparamsState)
        leaves = leaves[0]
    return leaves[0]["lowrank"]


def _ef_tensors(ef):
    return list(ef) if isinstance(ef, tuple) else [ef]


def test_migrate_keeps_unchanged_state_whole():
    opt = get_optimizer("dct_adamw", lr=1e-3, rank=6)
    params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
    state = opt.init(params)
    mig = tctl.migrate_opt_state(state, opt.init(params))
    assert all(a is b for (_, a), (_, b) in zip(tree_items(mig),
                                                tree_items(state))
               if isinstance(a, torch.Tensor))
    with pytest.raises(ValueError, match="differ"):
        tctl.migrate_opt_state(state, get_optimizer(
            "dct_adamw", lr=1e-3, rank=6).init(
                {k: v for k, v in params.items() if k != "b/kernel"}))


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------
# quanta of 2 (the reference's own closed-loop test): at the smoke model's
# width the captured energies of rank 16 differ by ~15%, which rounds back
# to 16 in quanta of 8
ALLOC_KW = dict(base_rank=16, deadband=0.0, decide_every=2, quantum=2,
                max_step=2)


def _jax_loop(steps):
    def make_optimizer(overrides=None):
        return jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, steps),
                                 rank=16, ef_dtype="fp32", fused="off",
                                 overrides=overrides)

    leaves = jctl.leaf_inventory(jax.eval_shape(
        lambda: JT.init_params(JAX_CFG, jax.random.PRNGKey(0))))
    log = []
    mgr = jada.AdaptiveOptimizerManager(
        make_optimizer=make_optimizer,
        make_step=lambda o: jax.jit(JS.make_train_step(JAX_CFG, o,
                                                       telemetry=True)),
        make_train_state=lambda o: JS.init_state(JAX_CFG, o,
                                                 jax.random.PRNGKey(0)),
        rank_allocator=jctl.RankAllocator(
            jctl.RankAllocatorConfig(**ALLOC_KW), leaves),
        log_fn=log.append)
    return mgr, log


def _torch_loop(steps, jparams):
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")

    def make_optimizer(overrides=None):
        return get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, steps),
                             rank=16, ef_dtype="fp32", fused="off",
                             overrides=overrides)

    log = []
    mgr = tada.AdaptiveOptimizerManager(
        make_optimizer=make_optimizer,
        make_step=lambda o: TS.make_train_step(CFG, o, telemetry=True),
        make_train_state=lambda o: TS.TrainState(
            0, dict(tparams), o.init(tparams)),
        rank_allocator=tctl.RankAllocator(
            tctl.RankAllocatorConfig(**ALLOC_KW),
            tctl.leaf_inventory(tparams)),
        log_fn=log.append)
    return mgr, log


def _data():
    return SyntheticLM(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4)


def _np_batch(data, s):
    return {k: np.array(v) for k, v in data.batch(jnp.int32(s)).items()}


def _torch_trainer(mgr, steps_data, ckpt_dir=None, **kw):
    data = _data()
    return Trainer(train_step=mgr.step, init_state_fn=mgr.init_state,
                   batch_fn=lambda s: {k: torch.from_numpy(v) for k, v in
                                       _np_batch(data, s).items()},
                   control_hook=mgr.control_hook, extra_state=mgr,
                   ckpt_dir=ckpt_dir, log_every=100, log_fn=QUIET, **kw)


def test_closed_loop_matches_jax():
    """Six steps of the tiny model in both packages from the same
    parameters and batches: the same reallocations at the same steps, the
    losses within 1e-5."""
    steps = 6
    jmgr, jlog = _jax_loop(steps)
    jtrainer = JaxTrainer(train_step=jmgr.step, init_state_fn=jmgr.init_state,
                          batch_fn=lambda s: _data().batch(jnp.int32(s)),
                          control_hook=jmgr.control_hook, extra_state=jmgr,
                          log_every=100, log_fn=QUIET)
    jstate = jtrainer.run(total_steps=steps)
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(0))
    tmgr, tlog = _torch_loop(steps, jparams)
    ttrainer = _torch_trainer(tmgr, steps)
    tstate = ttrainer.run(total_steps=steps)
    assert tmgr.n_rebuilds == jmgr.n_rebuilds >= 1
    decisions = [x for x in tlog if "rank reallocation" in x]
    assert decisions == [x for x in jlog if "rank reallocation" in x]
    assert tmgr.rank_allocator.alloc == jmgr.rank_allocator.alloc
    assert len(set(tmgr.rank_allocator.alloc.values())) > 1
    assert tmgr.rank_allocator.state_dict()["alloc"] == \
        jmgr.rank_allocator.state_dict()["alloc"]
    np.testing.assert_allclose(
        [h["loss"] for h in ttrainer.metrics_history],
        [float(h["loss"]) for h in jtrainer.metrics_history], rtol=1e-5)
    # each leaf's moments have its allocated rank
    for path, leaf in _lowrank(tstate.opt_state).items():
        assert leaf.m.shape[-1] == tmgr.rank_allocator.alloc[path]
    assert int(jstate.step) == tstate.step == steps


def test_resume_after_rebuild_bit_equal(tmp_path):
    """Stopped after step 4 (a rebuild at step 2, checkpoints at 2 and 4)
    and resumed to 6: the losses and the final state are bit-equal to the
    run that went straight through."""
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(0))
    mgr, _ = _torch_loop(6, jparams)
    full = _torch_trainer(mgr, 6)
    s_full = full.run(total_steps=6)
    mgr1, _ = _torch_loop(6, jparams)
    first = _torch_trainer(mgr1, 6, str(tmp_path), ckpt_every=2)
    first.run(total_steps=4)
    assert mgr1.n_rebuilds >= 1
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    saved_alloc = manifest["extra_state"]["rank_allocator"]["alloc"]
    assert saved_alloc == mgr1.rank_allocator.alloc
    mgr2, _ = _torch_loop(6, jparams)
    second = _torch_trainer(mgr2, 6, str(tmp_path), ckpt_every=2)
    s_res = second.run(total_steps=6)
    assert [h["step"] for h in second.metrics_history] == [5, 6]
    losses = [h["loss"] for h in first.metrics_history
              + second.metrics_history]
    assert losses == [h["loss"] for h in full.metrics_history]
    assert mgr2.rank_allocator.state_dict() == mgr.rank_allocator.state_dict()

    def bits(s):
        return [(p, x.numpy().tobytes() if isinstance(x, torch.Tensor)
                 else x) for p, x in tree_items(s)]
    assert bits(s_res) == bits(s_full)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--smoke", "--device", "cpu", "--optimizer", "dct_adamw", "--steps",
       "6", "--batch", "4", "--seq-len", "32", "--log-every", "1"]


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_cli_telemetry_writes_rows(tmp_path, fmt):
    path = tmp_path / f"tel.{fmt}"
    assert train_cli.main(CLI + ["--telemetry", fmt, "--telemetry-every", "2",
                                 "--telemetry-path", str(path)]) == 0
    lines = path.read_text().strip().splitlines()
    if fmt == "jsonl":
        rows = [json.loads(x) for x in lines]
        assert [r["step"] for r in rows] == [2.0, 4.0, 6.0]
        ce = [v for r in rows for k, v in r.items()
              if k.endswith("/captured_energy")]
        assert len(ce) == 3 * 7
        assert all(0 <= x <= 1 + 1e-5 for v in ce for x in v)
    else:
        header = lines[0].split(",")
        assert len(lines) == 4 and header[0] == "step"
        assert "telemetry/segments/0/p0/mlp/wd/kernel/ef_norm" in header


def test_cli_telemetry_default_path_and_resume_appends(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck"
    argv = CLI + ["--telemetry", "jsonl", "--telemetry-every", "2",
                  "--ckpt-dir", str(ck), "--ckpt-every", "2"]
    train_cli.run(train_cli.build(argv), stop_at=4)
    assert len((ck / "telemetry.jsonl").read_text().splitlines()) == 2
    train_cli.run(train_cli.build(argv))
    rows = [json.loads(x) for x in
            (ck / "telemetry.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2.0, 4.0, 6.0]
    train_cli.main(CLI[:-4] + ["--steps", "2", "--telemetry", "csv"])
    assert (tmp_path / "telemetry.csv").exists()


def test_cli_adaptive_rank_and_refresh(capsys):
    """At rank 128 (every column of the smoke model) the selection never
    drifts, so the scheduler doubles every leaf's interval at each
    decision; the allocator's spread stays under a quantum."""
    assert train_cli.main(CLI + ["--adaptive-rank", "--adaptive-refresh",
                                 "--control-every", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("refresh intervals ->") == 3
    assert "[adaptive] rebuild #1" in out and "basis cache" in out
    assert "[train] final rank allocation:" in out
    assert "[train] done at step 6" in out


@pytest.mark.parametrize("argv,msg", [
    (["--optimizer", "galore", "--adaptive-refresh"], "index-based"),
    (["--optimizer", "ldadamw", "--adaptive-refresh"], "index-based"),
    (["--optimizer", "trion", "--adaptive-refresh"], "projected-Adam"),
    (["--optimizer", "trion", "--adaptive-rank"], "projected-Adam"),
    (["--optimizer", "adamw", "--adaptive-rank"], "projected-Adam")])
def test_cli_adaptive_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                        *argv])


def test_cli_flag_defaults_match_jax():
    from repro.launch import train as jax_cli
    keys = ("telemetry", "telemetry_path", "telemetry_every",
            "adaptive_rank", "adaptive_refresh", "control_every")
    t, j = train_cli.build([]), jax_cli.build([])
    assert {k: getattr(t, k) for k in keys} == \
        {k: getattr(j, k) for k in keys} == {
            "telemetry": "off", "telemetry_path": None,
            "telemetry_every": 10, "adaptive_rank": False,
            "adaptive_refresh": False, "control_every": 50}
