"""The port's resilience layer against the JAX package: the escalation
ladder on the same health streams (exactly), ``scale_hyperparam`` on a
converted state (bit for bit), chaos plans, checkpoints written by either
package verified and restored by the other (bit for bit, and corruption
caught by both), the guarded step on a smoke llama with a chaos NaN, and
the resilient Trainer end to end through skip, rollback past a corrupted
checkpoint, and halt."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import llama_paper as jax_llama
from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import chaos as JC
from repro.train import checkpoint as JK
from repro.train import loop as JL
from repro.train import resilience as JR
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.optim.api import get_optimizer
from repro_torch.train import chaos as TC
from repro_torch.train import checkpoint as TK
from repro_torch.train import loop as TL
from repro_torch.train import resilience as TR
from repro_torch.train import steps as TS

JAX_CFG = jax_llama.SMOKE
CFG = get_config("llama-350m", smoke=True)
QUIET = dict(log_fn=lambda s: None)

# The smoke llama after a few guarded DCT-AdamW steps from the same
# converted state, at rank 128 (= n, no top-r selection): the frameworks
# differ only in the order of fp32 sums. Losses: the rank-128 trajectory
# tolerance of tests/test_torch_model_train.py, rtol 1e-5. Parameters: that
# file's gradient tolerance, 1e-4, on each leaf's update p_k - p_0 in
# relative Frobenius norm. Elementwise it cannot hold: Adam divides each
# moment by sqrt(v) + 1e-8, so a gradient element near 1e-8, the residue of
# a cancellation, carries its relative error of order 1e-3 into an update of
# size lr (measured: 4.1e-5 absolute after 4 steps, 7.6e-5 relative
# Frobenius in mlp/wd, without guard or chaos).
PARAM_RTOL = 1e-4
LOSS_RTOL = 1e-5
RANK = 128


# ---------------------------------------------------------------------------
# the ladder: the same (step, loss, finite) streams give the same actions
# ---------------------------------------------------------------------------
_EVENT = st.one_of(
    st.just(("nan", None)),                          # guard refused
    st.tuples(st.just("ok"), st.floats(0.5, 3.0)),   # healthy
    st.tuples(st.just("spike"), st.floats(20.0, 1e4)),
)


def _drive(mgr, events):
    """Feed ``events`` as the Trainer would (skip / rollback callbacks, a
    rollback to half the step); the decisions and the ladder's state."""
    out, step = [], 0
    for kind, val in events:
        loss = float("nan") if kind == "nan" else val
        a = mgr.observe(step + 1, loss, kind != "nan")
        out.append((a.kind, a.reason, a.lr_factor, mgr.data_offset,
                    mgr.lr_scale, mgr.loss_ema, mgr.state_dict()))
        if a.kind == "skip":
            mgr.skipped()
        elif a.kind == "rollback":
            to = step // 2
            mgr.rolled_back(from_step=step, to_step=to)
            step = to
        elif a.kind == "halt":
            break
        else:
            step += 1
    return out


@settings(max_examples=60, deadline=None)
@given(events=st.lists(_EVENT, min_size=1, max_size=80),
       max_skips=st.integers(0, 3), max_rollbacks=st.integers(0, 3),
       lr_cut=st.sampled_from([0.5, 0.3, 0.1]))
def test_ladder_actions_equal_jax(events, max_skips, max_rollbacks, lr_cut):
    kw = dict(max_skips=max_skips, max_rollbacks=max_rollbacks,
              lr_cut=lr_cut, ema_warmup=3, heal_steps=6, spike_patience=2)
    j = _drive(JR.ResilienceManager(JR.ResilienceConfig(**kw), **QUIET),
               events)
    t = _drive(TR.ResilienceManager(TR.ResilienceConfig(**kw), **QUIET),
               events)
    assert t == j


def test_ladder_state_dict_round_trip_and_dump(tmp_path):
    events = [("ok", 1.0)] * 4 + [("nan", None)] * 4 + [("ok", 1.0)]
    mgrs = [M.ResilienceManager(M.ResilienceConfig(max_skips=1), **QUIET)
            for M in (JR, TR)]
    for m in mgrs:
        _drive(m, events)
    assert mgrs[0].state_dict() == mgrs[1].state_dict()
    fresh = TR.ResilienceManager(**QUIET)
    fresh.load_state_dict(mgrs[0].state_dict())
    assert fresh.state_dict() == mgrs[1].state_dict()
    mgrs[1].halted = "drill"
    rec = json.loads(open(mgrs[1].dump(str(tmp_path / "h.json"),
                                       context={"trainer_step": 3})).read())
    assert rec["halted"] == "drill" and rec["trainer_step"] == 3
    assert rec["ladder"] == mgrs[1].state_dict()
    assert TR.HALT_EXIT_CODE == JR.HALT_EXIT_CODE == 86


# ---------------------------------------------------------------------------
# guard primitives and the LR-cut surgery
# ---------------------------------------------------------------------------
def test_all_finite_tree_and_select_tree():
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)},
            "i": torch.arange(3), "n": None, "k": 4, "e": torch.zeros(0),
            "h": torch.ones(2, dtype=torch.bfloat16)}
    assert bool(TR.all_finite_tree(good))
    assert not bool(TR.all_finite_tree(
        dict(good, b={"c": torch.tensor([[1.0, float("nan")], [0, 0]])})))
    for bad in (float("inf"), -float("inf"), float("nan")):
        assert not bool(TR.all_finite_tree(
            dict(good, a=torch.tensor([1.0, bad, 0.0]))))
    assert not bool(TR.all_finite_tree(
        dict(good, h=torch.tensor([float("nan")], dtype=torch.bfloat16))))
    assert bool(TR.all_finite_tree({"i": torch.arange(3)}))
    new, old = {"w": torch.ones(2)}, {"w": torch.zeros(2)}
    assert TR.select_tree(torch.tensor(False), new, old) is old
    assert TR.select_tree(torch.tensor(True), new, old) is new


@pytest.mark.parametrize("name", ["dct_adamw", "adamw", "trion"])
def test_scale_hyperparam_matches_jax_bit_for_bit(name):
    rng = np.random.default_rng(0)
    params = {"blk": {"w": {"kernel": rng.standard_normal(
        (24, 16)).astype(np.float32)}},
              "final_norm": {"scale": np.ones(16, np.float32)}}
    kw = {} if name == "adamw" else {"rank": 8}
    jst = jax_get_optimizer(name, lr=0.01, lr_scale=True, **kw).init(
        jax.tree.map(jnp.asarray, params))
    tst = convert.opt_state_from_jax(jax.tree.map(np.asarray, jst))
    for factor in (0.5, 0.3, 0.1 ** 3):
        jst, jh = JR.scale_hyperparam(jst, "lr_scale", factor)
        tst, th = TR.scale_hyperparam(tst, "lr_scale", factor)
        assert jh == th == 1
        want = np.asarray(jst.leaves[1].hyperparams["lr_scale"])
        got = tst.leaves[1].hyperparams["lr_scale"].numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    _, hits = TR.scale_hyperparam(tst, "nonexistent", 0.5)
    assert hits == 0


def test_scale_hyperparam_leaves_the_old_state_alone():
    opt = get_optimizer("dct_adamw", lr=0.01, rank=8, lr_scale=True)
    params = {"blk/w/kernel": torch.randn(24, 16)}
    state = opt.init(params)
    new, hits = TR.scale_hyperparam(state, "lr_scale", 0.25)
    assert hits == 1
    assert float(state.leaves[1].hyperparams["lr_scale"]) == 1.0
    assert float(new.leaves[1].hyperparams["lr_scale"]) == 0.25
    # the other tensors are carried over, not copied
    assert new.leaves[0][0]["lowrank"]["blk/w/kernel"].m is \
        state.leaves[0][0]["lowrank"]["blk/w/kernel"].m


# ---------------------------------------------------------------------------
# chaos plans
# ---------------------------------------------------------------------------
SPEC = [{"step": [3, 4], "site": "grads", "mode": "nan"},
        {"step": 6, "site": "checkpoint", "mode": "bitflip"},
        {"step": 7, "site": "checkpoint", "mode": "sigkill",
         "arg": "mid_write"},
        {"step": 2, "site": "data", "mode": "delay", "arg": 0.01}]


@pytest.mark.parametrize("wrapped", [False, True])
def test_chaos_spec_round_trip_equals_jax(tmp_path, wrapped):
    spec = {"faults": SPEC} if wrapped else SPEC
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    j = JC.ChaosPlan.load(str(path), **QUIET)
    t = TC.ChaosPlan.load(str(path), **QUIET)
    assert t.to_spec() == j.to_spec()
    assert len(t.faults) == 5
    assert TC.ChaosPlan.from_spec(t.to_spec(), **QUIET).to_spec() == \
        t.to_spec()


@pytest.mark.parametrize("bad,match", [
    (dict(site="nope", mode="nan"), "unknown fault site"),
    (dict(site="grads", mode="sigkill"), "has no mode"),
    (dict(site="checkpoint", mode="abort", arg="nope"), "stage")])
def test_chaos_fault_validation_matches_jax(bad, match):
    for F in (JC.Fault, TC.Fault):
        with pytest.raises(ValueError, match=match):
            F(step=1, **bad)


def test_chaos_stamp_and_tamper():
    plan = TC.ChaosPlan([TC.Fault(step=2, site="grads", mode="inf")],
                        **QUIET)
    fn = plan.wrap_batch_fn(lambda s: {"tokens": torch.zeros(2, 4)})
    batch = fn(7)
    assert batch["_chaos_step"] == 7 and isinstance(batch["_chaos_step"],
                                                    int)
    clean, cs = TC.strip_chaos_key(batch)
    assert "_chaos_step" not in clean and cs == 7
    assert TC.strip_chaos_key({"tokens": 1}) == ({"tokens": 1}, None)
    g = {"a": torch.ones(3)}
    assert plan.tamper_grads(1, g) is g
    assert torch.isinf(plan.tamper_grads(2, g)["a"]).all()


# ---------------------------------------------------------------------------
# checkpoint format: either package's checkpoints in the other
# ---------------------------------------------------------------------------
def _leaves():
    rng = np.random.default_rng(3)
    # w dominates the file, so a bit flipped at its middle lands in data
    return {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "q": rng.integers(-127, 128, (6, 5)).astype(np.int8),
            "idx": rng.integers(0, 99, (4, 3)).astype(np.int32),
            "nested": {"s": np.full((), 2.5, np.float32),
                       "n": np.asarray(7, np.int32)}}


def _jax_save(d, step, leaves):
    JK.CheckpointManager(str(d), keep=4, log=lambda s: None).save(
        step, jax.tree.map(jnp.asarray, leaves))


def _torch_save(d, step, leaves):
    TK.CheckpointManager(str(d), keep=4, log=lambda s: None).save(
        step, jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), leaves))


def _jax_restore(d, step, leaves):
    out = JK.CheckpointManager(str(d), log=lambda s: None).restore(
        step, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           leaves))
    return jax.tree.map(np.asarray, out)


def _torch_like(leaves):
    """Zero tensors of the leaves' shapes and dtypes: a restore target."""
    return jax.tree.map(lambda x: torch.zeros_like(torch.as_tensor(
        np.asarray(x))), leaves)


def _torch_restore(d, step, leaves):
    out = TK.CheckpointManager(str(d), log=lambda s: None).restore(
        step, _torch_like(leaves))
    return jax.tree.map(lambda t: t.numpy(), out)


PAIRS = {"jax->torch": (_jax_save, TK, _torch_restore),
         "torch->jax": (_torch_save, JK, _jax_restore)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_checkpoint_verifies_and_restores_across_packages(tmp_path, pair):
    save, reader, restore = PAIRS[pair]
    leaves = _leaves()
    save(tmp_path, 5, leaves)
    reader.CheckpointManager(str(tmp_path), log=lambda s: None).verify(5)
    got = restore(tmp_path, 5, leaves)
    for (_, want), (_, have) in zip(
            jax.tree_util.tree_flatten_with_path(leaves)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert have.dtype == want.dtype and have.shape == want.shape
        assert have.tobytes() == want.tobytes()


def _flip_shape(d, step):
    path = d / f"step_{step}" / "manifest.json"
    man = json.loads(path.read_text())
    man["leaves"]["w"]["shape"] = [48, 64]
    path.write_text(json.dumps(man))


CORRUPTIONS = {
    "bitflip": lambda d, s: TC.corrupt_file(
        str(d / f"step_{s}" / "state.npz"), mode="bitflip"),
    "truncate": lambda d, s: TC.corrupt_file(
        str(d / f"step_{s}" / "state.npz"), mode="truncate"),
    "shape": _flip_shape}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_checkpoint_corruption_caught_by_both(tmp_path, writer, corruption):
    leaves = _leaves()
    save = _jax_save if writer == "jax" else _torch_save
    save(tmp_path, 1, leaves)
    save(tmp_path, 2, leaves)
    CORRUPTIONS[corruption](tmp_path, 2)
    for mod in (JK, TK):
        cm = mod.CheckpointManager(str(tmp_path), log=lambda s: None)
        with pytest.raises(mod.CheckpointCorruptError):
            cm.verify(2)
        cm.verify(1)
    cm = TK.CheckpointManager(str(tmp_path), log=lambda s: None)
    step, restored = cm.restore_latest(_torch_like(leaves))
    assert step == 1 and (tmp_path / "step_2.corrupt").exists()
    assert restored["w"].numpy().tobytes() == leaves["w"].tobytes()


def test_checkpoint_bf16_leaf_round_trip(tmp_path):
    x = torch.randn(5, 7).to(torch.bfloat16)
    cm = TK.CheckpointManager(str(tmp_path), log=lambda s: None)
    cm.save(1, {"x": x, "k": 3})
    man = cm.manifest(1)["leaves"]
    assert man["x"]["dtype"] == "bfloat16" and man["k"]["dtype"] == "int64"
    got = cm.restore(1, {"x": torch.zeros(5, 7, dtype=torch.bfloat16),
                         "k": 0})
    assert torch.equal(got["x"], x) and got["k"] == 3


# ---------------------------------------------------------------------------
# the guarded step: a smoke llama, DCT-AdamW with lr_scale, a chaos NaN
# ---------------------------------------------------------------------------
def _np_batch(i, b=2, s=16):
    """A learnable batch of the JAX package's synthetic stream, as numpy."""
    data = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=s, global_batch=b)
    return {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}


def _start(lr_scale=True):
    kw = dict(rank=RANK, weight_decay=0.01, lr_scale=lr_scale)
    jopt = jax_get_optimizer("dct_adamw", lr=0.01, **kw)
    topt = get_optimizer("dct_adamw", lr=0.01, **kw)
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(0))
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))

    def tinit():
        host = jax.tree.map(np.asarray, jstate)
        return TS.TrainState(0, convert.params_from_jax(host.params),
                             convert.opt_state_from_jax(host.opt_state))
    return jopt, topt, jstate, tinit


def _bits(state):
    """Every leaf of a state: tensors as bytes, Python ints as they are."""
    return [(p, x.numpy().tobytes() if isinstance(x, torch.Tensor) else x)
            for p, x in TK.tree_items(state)]


def test_guarded_step_flags_params_and_refusal_match_jax():
    jopt, topt, jstate, tinit = _start()
    jplan = JC.ChaosPlan([JC.Fault(step=3, site="grads", mode="nan")],
                         **QUIET)
    tplan = TC.ChaosPlan([TC.Fault(step=3, site="grads", mode="nan")],
                         **QUIET)
    jstep = jax.jit(JS.make_train_step(JAX_CFG, jopt, guard=True,
                                       chaos=jplan))
    tstep = TS.make_train_step(CFG, topt, guard=True, chaos=tplan)
    jbatch = jplan.wrap_batch_fn(
        lambda s: jax.tree.map(jnp.asarray, _np_batch(s)))
    tbatch = tplan.wrap_batch_fn(
        lambda s: {k: torch.from_numpy(v) for k, v in _np_batch(s).items()})
    tstate = tinit()
    p0 = dict(tstate.params)
    jflags, tflags, jl, tl = [], [], [], []
    for i in range(5):
        before = _bits(tstate)
        jstate, jm = jstep(jstate, jbatch(i))
        tstate, tm = tstep(tstate, tbatch(i))
        jflags.append(bool(jm["all_finite"]))
        tflags.append(bool(tm["all_finite"]))
        if not tflags[-1]:
            # the refused step left the old state, bit for bit
            assert _bits(tstate) == before
        else:
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
    assert tflags == jflags == [True, True, True, False, True]
    assert int(jstate.step) == tstate.step == 4
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, p in tstate.params.items():
        moved = want[k] - p0[k]
        err = float((p - want[k]).norm() / moved.norm())
        assert err <= PARAM_RTOL, (k, err)


def test_guard_off_returns_no_flag_and_same_numbers():
    _, topt, _, tinit = _start(lr_scale=False)
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(0).items()}
    s0, m0 = TS.make_train_step(CFG, topt)(tinit(), batch)
    s1, m1 = TS.make_train_step(CFG, topt, guard=True)(tinit(), batch)
    assert "all_finite" not in m0 and bool(m1["all_finite"])
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k])


# ---------------------------------------------------------------------------
# the resilient Trainer end to end, both packages on the same batches
# ---------------------------------------------------------------------------
def _run_trainers(tmp_path, faults, total, res_kw, keep=4):
    jopt, topt, jstate0, tinit = _start()
    out = {}
    for name in ("jax", "torch"):
        C, L, R, S = (JC, JL, JR, JS) if name == "jax" else (TC, TL, TR, TS)
        plan = C.ChaosPlan([C.Fault(**f) for f in faults], **QUIET)
        if name == "jax":
            step = jax.jit(JS.make_train_step(JAX_CFG, jopt, guard=True,
                                              chaos=plan))
            init = lambda: jstate0                         # noqa: E731
            batch = lambda s: jax.tree.map(jnp.asarray,     # noqa: E731
                                           _np_batch(s))
        else:
            step = TS.make_train_step(CFG, topt, guard=True, chaos=plan)
            init = tinit
            batch = lambda s: {k: torch.from_numpy(v)      # noqa: E731
                               for k, v in _np_batch(s).items()}
        d = tmp_path / name
        res = R.ResilienceManager(R.ResilienceConfig(**res_kw), **QUIET)
        lines = []
        trainer = L.Trainer(
            train_step=step, init_state_fn=init,
            batch_fn=plan.wrap_batch_fn(batch), ckpt_dir=str(d),
            ckpt_every=2, keep=keep, log_every=100, log_fn=lines.append,
            resilience=res, ckpt_fault_hook=plan.bind_checkpoint_dir(str(d)))
        halted = False
        try:
            trainer.run(total_steps=total)
        except R.TrainingHalted:
            halted = True
        # the action log: the ladder's and the trainer's lines (the
        # checkpoint manager's name leaf paths, which differ by package)
        out[name] = dict(lines=[ln for ln in lines
                                if ln.startswith(("[resilience]",
                                                  "[trainer]"))],
                         ckpt_lines=[ln for ln in lines
                                     if ln.startswith("[ckpt]")],
                         res=res, dir=d, halted=halted,
                         losses=[float(m["loss"])
                                 for m in getattr(trainer, "metrics_history",
                                                  [])])
    return out


def test_resilient_trainer_rolls_back_past_corrupt_checkpoint_like_jax(
        tmp_path):
    faults = [dict(step=s, site="grads", mode="nan") for s in (5, 6, 7)] \
        + [dict(step=4, site="checkpoint", mode="bitflip")]
    out = _run_trainers(tmp_path, faults, 10, dict(max_skips=2,
                                                   max_rollbacks=3))
    j, t = out["jax"], out["torch"]
    assert t["lines"] == j["lines"]
    assert any("rollback: step 5 -> 2" in ln for ln in t["lines"])
    assert t["res"].state_dict() == j["res"].state_dict()
    assert t["res"].n_rollbacks == 1 and t["res"].n_skips == 2
    for side in (j, t):
        assert (side["dir"] / "step_4.corrupt").exists()
        assert any("quarantined corrupt checkpoint step 4" in ln
                   for ln in side["ckpt_lines"])
        assert not side["halted"]
    # steps 1-5, rollback to 2, steps 3-10 again on the shifted data
    assert len(t["losses"]) == len(j["losses"]) == 13
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LOSS_RTOL)
    saved = TK.CheckpointManager(str(t["dir"]), log=lambda s: None)
    assert saved.manifest(saved.latest_step())["resilience"] == \
        t["res"].state_dict()


def test_resilient_trainer_halts_on_exhausted_ladder_like_jax(tmp_path):
    faults = [dict(step=s, site="grads", mode="nan") for s in range(40)]
    out = _run_trainers(tmp_path, faults, 10, dict(max_skips=1,
                                                   max_rollbacks=2,
                                                   lr_cut=0.5))
    j, t = out["jax"], out["torch"]
    assert t["halted"] and j["halted"]
    assert t["lines"] == j["lines"]
    assert t["res"].lr_scale == j["res"].lr_scale == 0.5
    for side in (j, t):
        rec = json.loads((side["dir"] / "halt.json").read_text())
        assert rec["halted"] and rec["ladder"]["n_rollbacks"] == 3
