"""The port's training substrate: the prefetching data pipeline, checkpoints
(keep-k, atomic async saves, a writer killed mid-write, save draining a
pending writer), Trainer resume bit-equal to an uninterrupted run, SIGTERM
preemption, the log hooks, the bf16 gradient accumulator and the eval step
against the JAX package, the restart supervisor, the schedules and the
CLI's checkpoint / resilience / obs flags — the invariants of
tests/test_train_substrate.py and tests/test_resilience.py."""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama_paper as jax_llama
from repro.models import transformer as JT
from repro.optim.common import Optimizer as JaxOptimizer
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.launch import train as train_cli
from repro_torch.optim.api import get_optimizer
from repro_torch.optim.common import Optimizer
from repro_torch.train import (constant, cosine_warmup, linear_warmup,
                               make_eval_step)
from repro_torch.train import steps as TS
from repro_torch.train.chaos import ChaosPlan, Fault
from repro_torch.train.checkpoint import CheckpointManager, tree_items
from repro_torch.train.loop import Trainer
from repro_torch.train.resilience import HALT_EXIT_CODE
from repro_torch.train.supervisor import checkpoint_progress_fn, supervise

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = jax_llama.SMOKE
CFG = get_config("llama-350m", smoke=True)
QUIET = lambda s: None  # noqa: E731


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def test_pipeline_prefetches_in_order():
    calls = []

    def fn(step):
        calls.append(step)
        return {"step": step}

    p = DataPipeline(fn, start_step=3, depth=2, timeout_s=2.0)
    try:
        for s in range(3, 8):
            assert p.get(s)["step"] == s
    finally:
        p.close()
    assert calls[:5] == [3, 4, 5, 6, 7]


def test_pipeline_straggler_recomputed_inline_bit_equal():
    batch_fn = make_batch_fn(CFG, 16, 2, seed=1, device="cpu")
    slow = threading.Event()

    def fn(step):
        if step == 1 and not slow.is_set():
            slow.set()
            time.sleep(0.3)                    # the worker's copy is late
        return batch_fn(step)

    p = DataPipeline(fn, depth=1, timeout_s=0.1)
    try:
        assert torch.equal(p.get(0)["tokens"], batch_fn(0)["tokens"])
        got = p.get(1)                         # recomputed inline
        assert slow.is_set()
        for k, v in batch_fn(1).items():
            assert torch.equal(got[k], v)
    finally:
        p.close()


def test_pipeline_retries_transient_errors():
    calls = []

    def flaky(step):
        calls.append(step)
        if step == 1 and calls.count(1) < 3:
            raise OSError("transient storage blip")
        return {"step": step}

    p = DataPipeline(flaky, depth=2, timeout_s=5.0, retries=3,
                     retry_backoff_s=0.01)
    try:
        for s in range(3):
            assert p.get(s)["step"] == s
    finally:
        p.close()
    assert calls.count(1) == 3


def test_pipeline_raises_persistent_error():
    def broken(step):
        if step >= 1:
            raise ValueError("bad shard")
        return {"step": step}

    p = DataPipeline(broken, depth=2, timeout_s=10.0, retries=1,
                     retry_backoff_s=0.01)
    try:
        assert p.get(0)["step"] == 0
        with pytest.raises(RuntimeError, match="failed permanently"):
            p.get(1)
    finally:
        p.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state():
    return {"w": torch.arange(6.0).reshape(2, 3), "step": 5,
            "nested": {"b": torch.ones(4), "none": None}}


def test_checkpoint_round_trip_keep_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, log=QUIET)
    for s in (10, 20, 30):
        cm.save(s, _state())
    assert cm.all_steps() == [20, 30]
    got = cm.restore(30, {"w": torch.zeros(2, 3), "step": 0,
                          "nested": {"b": torch.zeros(4), "none": None}})
    assert torch.equal(got["w"], _state()["w"]) and got["step"] == 5
    assert isinstance(got["step"], int) and got["nested"]["none"] is None
    with pytest.raises(TypeError, match="holds no float"):
        cm.save(40, {"lr": 0.5})


def test_checkpoint_async_and_atomic(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3, log=QUIET)
    state = {"w": torch.ones(8, 8)}
    cm.async_save(1, state)
    cm.wait()
    assert cm.latest_step() == 1
    os.makedirs(tmp_path / "step_99.tmp", exist_ok=True)
    assert cm.latest_step() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    cm = CheckpointManager(str(tmp_path), log=QUIET)
    w = torch.ones(4)
    cm.async_save(1, {"w": w})
    w.add_(1.0)                                # after the call: not saved
    cm.wait()
    assert torch.equal(cm.restore(1, {"w": torch.zeros(4)})["w"],
                       torch.ones(4))


def test_async_writer_killed_midwrite(tmp_path):
    plan = ChaosPlan([Fault(step=2, site="checkpoint", mode="abort",
                            arg="mid_write")], log_fn=QUIET)
    cm = CheckpointManager(str(tmp_path), keep=3, log=QUIET,
                           fault_hook=plan.bind_checkpoint_dir(str(tmp_path)))
    state = {"w": torch.ones(8, 8)}
    cm.async_save(1, state)
    cm.wait()
    cm.async_save(2, state)                    # the writer dies mid-write
    cm.wait()
    assert cm.latest_verified_step() == 1
    assert (tmp_path / "step_2.tmp").exists()
    cm2 = CheckpointManager(str(tmp_path), log=QUIET)
    assert not (tmp_path / "step_2.tmp").exists()
    assert cm2.latest_verified_step() == 1


def test_save_drains_pending_writer(tmp_path):
    release = threading.Event()

    def slow_hook(stage, step):
        if stage == "pre_publish" and step == 1:
            release.wait(5.0)

    cm = CheckpointManager(str(tmp_path), keep=2, log=QUIET,
                           fault_hook=slow_hook)
    state = {"w": torch.ones(4)}
    cm.async_save(1, state)
    time.sleep(0.05)                           # the writer parks pre-publish
    t = threading.Thread(target=lambda: (time.sleep(0.05), release.set()))
    t.start()
    cm.save(2, state)                          # must drain 1 first
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert cm.all_steps() == [1, 2]
    for s in (1, 2):
        cm.verify(s)


def test_checkpoint_preformat_loads_unverified(tmp_path):
    cm = CheckpointManager(str(tmp_path), log=QUIET)
    cm.save(3, {"w": torch.ones(4)})
    path = tmp_path / "step_3" / "manifest.json"
    man = json.loads(path.read_text())
    del man["leaves"]
    path.write_text(json.dumps(man))
    assert cm.latest_verified_step() == 3
    cm.restore(3, {"w": torch.zeros(4)})


# ---------------------------------------------------------------------------
# the Trainer: resume, preemption, hooks
# ---------------------------------------------------------------------------
def _trainer(name, ckpt_dir=None, **kw):
    opt = get_optimizer(name, lr=cosine_warmup(0.01, 2, 6), rank=16,
                        weight_decay=0.01)
    return Trainer(train_step=TS.make_train_step(CFG, opt),
                   init_state_fn=lambda: TS.init_state(CFG, opt, seed=0,
                                                       device="cpu"),
                   batch_fn=make_batch_fn(CFG, 16, 2, seed=0, device="cpu"),
                   ckpt_dir=ckpt_dir, log_every=100, log_fn=QUIET, **kw)


def _bits(state):
    """Every leaf of a state: tensors as bytes, Python ints as they are."""
    return [(p, x.numpy().tobytes() if isinstance(x, torch.Tensor) else x)
            for p, x in tree_items(state)]


@pytest.mark.parametrize("name", ["dct_adamw", "trion"])
def test_trainer_resume_bit_equal_to_uninterrupted(tmp_path, name):
    full = _trainer(name)
    s_full = full.run(total_steps=6)
    first = _trainer(name, str(tmp_path), ckpt_every=3)
    first.run(total_steps=3)
    second = _trainer(name, str(tmp_path), ckpt_every=3)
    s_resumed = second.run(total_steps=6)
    assert [h["step"] for h in second.metrics_history] == [4, 5, 6]
    losses = [h["loss"] for h in first.metrics_history
              + second.metrics_history]
    assert losses == [h["loss"] for h in full.metrics_history]
    assert _bits(s_resumed) == _bits(s_full)


def test_sigterm_checkpoints_and_resume_finishes(tmp_path):
    def preempt(record):
        if record["step"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    lines = []
    t1 = _trainer("dct_adamw", str(tmp_path), ckpt_every=100,
                  log_metrics=preempt)
    t1.log = lines.append
    handler = signal.getsignal(signal.SIGTERM)
    s1 = t1.run(total_steps=6)
    assert signal.getsignal(signal.SIGTERM) is handler   # put back
    assert s1.step == 2 and any("SIGTERM" in ln for ln in lines)
    assert CheckpointManager(str(tmp_path), log=QUIET).all_steps() == [2]
    s2 = _trainer("dct_adamw", str(tmp_path), ckpt_every=100).run(6)
    assert _bits(s2) == _bits(_trainer("dct_adamw").run(6))


def test_trainer_log_metrics_hook_and_console():
    records, lines = [], []
    trainer = _trainer("trion", log_metrics=records.append)
    trainer.log_every, trainer.log = 2, lines.append
    trainer.run(total_steps=4)
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all("loss" in r and "s_per_step" in r for r in records)
    assert len(lines) == 2
    assert lines[0].startswith("[trainer] step 2 loss ")
    assert "ms/step" in lines[0]


class _Counter:
    """A toy controller: state in the manifest, a hook that sees each step."""

    def __init__(self):
        self.seen = []

    def state_dict(self):
        return {"seen": list(self.seen)}

    def load_state_dict(self, d):
        self.seen = list(d["seen"])

    def hook(self, step, state, metrics):
        self.seen.append(step)
        return None


def test_control_hook_and_extra_state_ride_the_checkpoint(tmp_path):
    c1 = _Counter()
    _trainer("dct_adamw", str(tmp_path), ckpt_every=2,
             control_hook=c1.hook, extra_state=c1).run(3)
    assert c1.seen == [1, 2, 3]
    c2 = _Counter()
    _trainer("dct_adamw", str(tmp_path), ckpt_every=2,
             control_hook=c2.hook, extra_state=c2).run(4)
    # restored from step 2's manifest, then steps 3-4
    assert c2.seen == [1, 2, 3, 4]


def test_sync_sample_and_spans_recorded():
    from repro_torch import obs
    obs.enable()
    obs.reset()
    try:
        _trainer("dct_adamw", sync_sample_every=2).run(4)
        snap = obs.registry().snapshot()
        names = {r["name"] for r in obs.tracer().records()}
    finally:
        obs.disable()
        obs.reset()
    for h in ("train_data_wait_seconds", "train_dispatch_seconds",
              "train_host_sync_seconds", "train_step_seconds"):
        assert snap[h]["series"][()]["count"] == 4, snap[h]
    assert snap["train_full_sync_seconds"]["series"][()]["count"] == 2
    assert {"train/data_wait", "train/dispatch", "train/host_sync",
            "train/full_sync"} <= names


# ---------------------------------------------------------------------------
# the step against the JAX package: bf16 accumulation, the eval step
# ---------------------------------------------------------------------------
def _capture_grads_jax():
    """An optimizer that keeps the gradients it is given as its state."""
    return JaxOptimizer(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p: (jax.tree.map(jnp.zeros_like, g), g))


def _capture_grads_torch():
    return Optimizer(
        init=lambda p: {k: torch.zeros_like(v) for k, v in p.items()},
        update=lambda g, s, p: ({k: torch.zeros_like(v)
                                 for k, v in g.items()}, g))


def _np_batch(seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, CFG.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("accum_dtype", ["bfloat16", "float32"])
def test_accumulated_gradients_match_jax(accum_dtype):
    """Two microbatches of 2 rows, gradients accumulated in ``accum_dtype``
    and clipped. bf16: the shares are rounded to bf16 in both packages, so
    they agree to a bf16 ulp or two of max |g| (2 ** -7 of it); fp32 at
    the gradient tolerance of tests/test_torch_model_train.py."""
    jcfg = dataclasses.replace(JAX_CFG, train_microbatch=2)
    tcfg = dataclasses.replace(CFG, train_microbatch=2)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    batch = _np_batch(0)
    jopt, topt = _capture_grads_jax(), _capture_grads_torch()
    jstate, _ = jax.jit(JS.make_train_step(jcfg, jopt,
                                           accum_dtype=accum_dtype))(
        JS.TrainState(jnp.zeros((), jnp.int32), jparams, jopt.init(jparams)),
        jax.tree.map(jnp.asarray, batch))
    tparams = convert.params_from_jax(host, device="cpu")
    tstate, _ = TS.make_train_step(tcfg, topt, accum_dtype=accum_dtype)(
        TS.TrainState(0, tparams, topt.init(tparams)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jstate.opt_state),
        device="cpu")
    rtol = 2.0 ** -7 if accum_dtype == "bfloat16" else 1e-4
    for k, g in tstate.opt_state.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=k)


def test_accum_dtype_rejects_unknown_and_telemetry_is_unported():
    """The name predates telemetry's port: an unknown accum_dtype is still
    refused, and telemetry=True now returns the stats."""
    opt = get_optimizer("adamw", lr=0.01)
    with pytest.raises(ValueError, match="accum_dtype"):
        TS.make_train_step(CFG, opt, accum_dtype="float16")
    # adamw has no low-rank leaf: nothing to record, no telemetry entry
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(2).items()}
    _, m = TS.make_train_step(CFG, opt, telemetry=True)(
        TS.init_state(CFG, opt, seed=0, device="cpu"), batch)
    assert "telemetry" not in m
    opt = get_optimizer("dct_adamw", lr=0.01, rank=16)
    _, m = TS.make_train_step(CFG, opt, telemetry=True)(
        TS.init_state(CFG, opt, seed=0, device="cpu"), batch)
    assert len(m["telemetry"]) == 7


def test_eval_step_matches_jax():
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(1))
    batch = _np_batch(2)
    jm = jax.jit(JS.make_eval_step(JAX_CFG))(
        jparams, jax.tree.map(jnp.asarray, batch))
    tm = make_eval_step(CFG)(
        convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == {"ce", "loss"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert not tm["loss"].requires_grad


def test_schedules():
    assert linear_warmup(1.0, 10)(5) == pytest.approx(0.5)
    assert constant(0.3)(17) == 0.3
    c = cosine_warmup(1.0, 10, 110, final_frac=0.1)
    assert c(110) == pytest.approx(0.1, abs=1e-3)
    assert c(10) == pytest.approx(1.0, abs=1e-2)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
def _child_script(tmp_path, fail_until: int, progress: bool) -> list[str]:
    """A scripted child: counts its runs, optionally 'writes a checkpoint'
    (bumps a progress file), exits 1 until run >= fail_until."""
    script = textwrap.dedent(f"""
        import os, sys
        d = {str(tmp_path)!r}
        cp = os.path.join(d, "count")
        n = int(open(cp).read()) + 1 if os.path.exists(cp) else 1
        open(cp, "w").write(str(n))
        if {progress!r}:
            open(os.path.join(d, "progress"), "w").write(str(n))
        sys.exit(0 if n >= {fail_until} else 1)
    """)
    return [sys.executable, "-c", script]


def _progress_fn(tmp_path):
    def fn():
        p = os.path.join(str(tmp_path), "progress")
        return int(open(p).read()) if os.path.exists(p) else None
    return fn


def test_supervise_restarts_until_success(tmp_path):
    lines = []
    rc = supervise(_child_script(tmp_path, 3, progress=True),
                   max_restarts=5, backoff_s=0.01, log=lines.append,
                   progress_fn=_progress_fn(tmp_path))
    assert rc == 0
    assert (tmp_path / "count").read_text() == "3"
    assert any("resume context" in ln for ln in lines)
    assert any("budget reset" in ln for ln in lines)


def test_supervise_budget_resets_on_progress(tmp_path):
    rc = supervise(_child_script(tmp_path, 4, progress=True),
                   max_restarts=1, backoff_s=0.01, log=QUIET,
                   progress_fn=_progress_fn(tmp_path))
    assert rc == 0


def test_supervise_halts_on_crash_loop(tmp_path):
    lines = []
    rc = supervise(_child_script(tmp_path, 99, progress=False),
                   max_restarts=10, backoff_s=0.01, log=lines.append,
                   progress_fn=_progress_fn(tmp_path), crash_loop_limit=3)
    assert rc == 1
    assert (tmp_path / "count").read_text() == "3"
    assert any("crash loop" in ln for ln in lines)


def test_supervise_never_restarts_deliberate_halt(tmp_path):
    script = textwrap.dedent(f"""
        import os, sys
        cp = os.path.join({str(tmp_path)!r}, "count")
        n = int(open(cp).read()) + 1 if os.path.exists(cp) else 1
        open(cp, "w").write(str(n))
        sys.exit({HALT_EXIT_CODE})
    """)
    lines = []
    rc = supervise([sys.executable, "-c", script], max_restarts=5,
                   backoff_s=0.01, log=lines.append)
    assert rc == HALT_EXIT_CODE == 86
    assert (tmp_path / "count").read_text() == "1"
    assert any("halted deliberately" in ln for ln in lines)


def test_checkpoint_progress_fn(tmp_path):
    fn = checkpoint_progress_fn(str(tmp_path / "none"))
    assert fn() is None
    cm = CheckpointManager(str(tmp_path), log=QUIET)
    for s in (2, 4):
        cm.save(s, {"w": torch.ones(2)})
    os.makedirs(tmp_path / "step_9.tmp")
    assert checkpoint_progress_fn(str(tmp_path))() == 4


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------
CLI = ["--smoke", "--device", "cpu", "--optimizer", "dct_adamw", "--rank",
       "16", "--batch", "2", "--seq-len", "16", "--warmup", "2",
       "--log-every", "1"]


def _final_loss(out: str) -> str:
    return out.rsplit("loss ", 1)[1].split()[0]


def test_cli_resumes_from_ckpt_dir(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train_cli.main(CLI + ["--steps", "5"]) == 0
    straight = _final_loss(capsys.readouterr().out)
    assert train_cli.main(CLI + ["--steps", "5", "--ckpt-dir", ck,
                                 "--ckpt-every", "2", "--resilient"]) == 0
    capsys.readouterr()
    for p in Path(ck).iterdir():               # resume from step 2
        if p.name != "step_2":
            shutil.rmtree(p)
    assert train_cli.main(CLI + ["--steps", "5", "--ckpt-dir", ck,
                                 "--ckpt-every", "2", "--resilient"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 2" in out
    assert _final_loss(out) == straight


def test_cli_resilient_chaos_halts_with_86(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"step": list(range(20)), "site": "grads",
                                 "mode": "nan"}]))
    ck = tmp_path / "ck"
    rc = train_cli.main(CLI + ["--steps", "4", "--ckpt-dir", str(ck),
                               "--resilient", "--chaos", str(plan),
                               "--max-skips", "1", "--max-rollbacks", "1"])
    assert rc == HALT_EXIT_CODE
    rec = json.loads((ck / "halt.json").read_text())
    assert rec["halted"] and rec["ladder"]["n_rollbacks"] == 2
    assert "[train] halted:" in capsys.readouterr().out


def test_cli_obs_dir_writes_both_files(tmp_path, capsys):
    from repro_torch import obs
    d = tmp_path / "obs"
    obs.reset()
    try:
        assert train_cli.main(CLI + ["--steps", "2", "--obs-dir", str(d),
                                     "--obs-sync-every", "1"]) == 0
    finally:
        obs.disable()
        obs.reset()
    prom = (d / "metrics.prom").read_text()
    assert "train_dispatch_seconds" in prom
    assert "train_full_sync_seconds_count 2" in prom
    assert json.loads((d / "trace.json").read_text())["traceEvents"]


def test_cli_flags_and_resilient_optimizer(monkeypatch):
    for flag in ("--ckpt-dir", "--ckpt-every", "--supervise", "--resilient",
                 "--max-skips", "--max-rollbacks", "--lr-cut", "--chaos",
                 "--obs-dir", "--obs-sync-every"):
        assert flag not in train_cli.NOT_YET_PORTED
    assert set(train_cli.NOT_YET_PORTED) == {"--tune-cache"}
    args = train_cli.build(CLI + ["--resilient"])
    assert (args.max_skips, args.max_rollbacks, args.lr_cut,
            args.ckpt_every, args.obs_sync_every) == (2, 3, 0.5, 50, 0)
    kw = train_cli._optimizer_kwargs(args, torch.device("cpu"))
    assert kw["lr_scale"] is True


def test_cli_supervise_reexecutes_without_the_flag(tmp_path):
    """``--supervise`` runs ``python -m repro_torch.launch.train`` again as
    the supervisor's child; a child killed mid-write resumes and finishes."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"step": 4, "site": "checkpoint",
                                 "mode": "sigkill", "arg": "mid_write"}]))
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI, "--steps",
         "5", "--ckpt-dir", str(ck), "--ckpt-every", "2", "--chaos",
         str(plan), "--supervise"], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert text.count("[supervisor] launching") == 2, text
    assert "resumed from checkpoint step 2" in text
    assert "[train] done at step 5" in text
    assert CheckpointManager(str(ck), log=QUIET).latest_verified_step() == 4
