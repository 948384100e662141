"""Subspace telemetry of the port against the JAX package's: the per-leaf
stats of every rule family on the same inputs, the invariants of
``tests/test_telemetry.py``, the train step's ``metrics["telemetry"]``, the
Trainer's one bulk copy, and the sink's files byte for byte.

The stats cases build a JAX state, carry it across with
``repro_torch.convert`` and take the same steps in both packages on the same
numpy gradients (a stacked leaf and a transposed one), with a collector
installed around each update. Energies are held at rtol 1e-5 (fp32 sums in
another order); the -1 sentinels and ``index_overlap`` exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import selection as jsel
from repro.core.dct import dct2_matrix as jax_dct2
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.telemetry import sink as jsink
from repro.telemetry import stats as jstats
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.core import reconstruction_error_sq
from repro_torch.core import selection as tsel
from repro_torch.core.dct import dct2_matrix
from repro_torch.optim import transform as ttf
from repro_torch.optim.api import get_optimizer
from repro_torch.telemetry import sink as tsink
from repro_torch.telemetry import stats as tstats
from repro_torch.train import steps as TS
from repro_torch.train.loop import Trainer

from test_torch_baselines import spectral
from test_torch_fused_step import planted
from test_torch_model_train import CFG, JAX_CFG, _batch

FIELDS = tstats.SubspaceStats._fields
# a stacked leaf (projected dim last) and one that orients by transposing
LEAVES = {"a/kernel": (3, 40, 24), "b/kernel": (24, 48)}
R = 6
QUIET = lambda *a, **k: None  # noqa: E731


def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _params_np():
    rng = np.random.default_rng(0)
    flat = {p: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for p, s in LEAVES.items()}
    flat["final_norm/scale"] = np.zeros(24, np.float32)
    return flat


def _grads_np(seed, make=planted):
    """Gradients in each parameter's layout, made in the oriented one."""
    flat = {}
    for i, (p, shape) in enumerate(LEAVES.items()):
        m, n = shape[-2:]
        if n <= m:
            flat[p] = make(shape, seed + i)
        else:
            flat[p] = np.swapaxes(make((*shape[:-2], n, m), seed + i),
                                  -1, -2).copy()
    rng = np.random.default_rng(seed + 50)
    flat["final_norm/scale"] = rng.standard_normal(24).astype(np.float32)
    return flat


def _jax_update_with_stats(jopt):
    def upd(g, s, p):
        with jstats.collect() as col:
            u, s2 = jopt.update(g, s, p)
        return u, s2, col.tree()
    return jax.jit(upd)


def _torch_update_with_stats(topt, g, s, p):
    with tstats.collect() as col:
        u, s2 = topt.update(g, s, p)
    return u, s2, col.tree()


def _assert_stats_close(got: dict, want: dict, msg=""):
    """Port stats (tensors) against JAX stats (by path), field by field."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for path, st in got.items():
        for name, t, w in zip(FIELDS, st, want[path]):
            t, w = t.numpy(), np.asarray(w)
            assert t.shape == w.shape, (msg, path, name)
            if name == "index_overlap":
                np.testing.assert_array_equal(t, w, err_msg=f"{msg} {path}")
            elif name == "topr_margin" and (w < 0).any():
                np.testing.assert_array_equal(t, w, err_msg=f"{msg} {path}")
            elif name == "topr_margin":
                # (v_r - v_r+1) / v_1: a difference of two close column
                # energies in units of the largest, so its error is the
                # norms' relative error (~1e-6), not a share of the margin
                np.testing.assert_allclose(t, w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{msg} {path} {name}")
            else:
                np.testing.assert_allclose(t, w, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{msg} {path} {name}")


# (preset, keywords, gradient maker, steps): DCT-AdamW refreshes on steps
# 1 and 3 and keeps on step 2 (update_interval 2), in every execution
# layer, with int8 EF, fp32 EF and none; the baselines and the momentum
# families with their CLI projectors
STATS_CASES = {
    **{f"dct_adamw-{mode}-{ef}": (
        "dct_adamw", {"fused": mode, "update_interval": 2,
                      **({"error_feedback": False} if ef == "noef"
                         else {"ef_dtype": ef})}, planted, 3)
       for mode in ("off", "fft", "on") for ef in ("q8", "fp32", "noef")},
    "ldadamw": ("ldadamw", {}, spectral, 2),
    "galore-dct": ("galore", {"projector": "dct", "update_interval": 2},
                   planted, 3),
    "trion": ("trion", {}, planted, 2),
    "trion-on": ("trion", {"fused": "on"}, planted, 2),
    "muon-r16": ("muon", {"rank": 16}, planted, 2),
    "dion": ("dion", {}, planted, 2),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_stats_match_jax(case):
    name, kw, make, steps = STATS_CASES[case]
    kw = dict(kw, weight_decay=0.01)
    if name != "muon":
        kw["rank"] = R
    jopt = jax_get_optimizer(name, lr=0.01, **kw)
    topt = get_optimizer(name, lr=0.01, **kw)
    params_np = _params_np()
    jparams = jax.tree.map(jnp.asarray, _nest(params_np))
    jstate = jopt.init(jparams)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    tparams = {k: torch.from_numpy(v) for k, v in params_np.items()}
    jupd = _jax_update_with_stats(jopt)
    for step in range(1, steps + 1):
        g = _grads_np(10 * step, make)
        ju, jstate, jtel = jupd(jax.tree.map(jnp.asarray, _nest(g)), jstate,
                                jparams)
        tu, tstate, ttel = _torch_update_with_stats(
            topt, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            tparams)
        assert set(ttel) == set(LEAVES)
        _assert_stats_close(ttel, jtel, f"{case} step {step}")
        keep = kw.get("update_interval", 1) > 1 and step % 2 == 0
        for st in ttel.values():
            ce = st.captured_energy.numpy()
            assert np.all((ce >= 0) & (ce <= 1 + 1e-5))
            if keep:
                assert (st.topr_margin == -1).all()
                assert (st.index_overlap == -1).all()


def test_keep_step_sentinels_and_refresh_measurements():
    """update_interval 3: steps 2-3 keep (both sentinels -1), steps 1 and 4
    refresh (a fused refresh has the norms: margin and overlap measured)."""
    topt = get_optimizer("dct_adamw", lr=0.01, rank=R, update_interval=3,
                         fused="fft")
    params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
    state = topt.init(params)
    for step in range(1, 5):
        g = {k: torch.from_numpy(v) for k, v in _grads_np(step).items()}
        _, state, tel = _torch_update_with_stats(topt, g, state, params)
        st = tel["a/kernel"]
        if step in (2, 3):
            assert (st.topr_margin == -1).all()
            assert (st.index_overlap == -1).all()
        else:
            assert (st.topr_margin >= 0).all()
            assert (st.index_overlap >= 0).all()


@pytest.mark.parametrize("mode", ["off", "fft", "on"])
def test_ef_norm_is_the_stored_buffer_norm(mode):
    """ef_norm (the orthogonal split) equals ||EF||_F of the fp32 buffer."""
    topt = get_optimizer("dct_adamw", lr=0.01, rank=R, ef_dtype="fp32",
                         fused=mode)
    params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
    state = topt.init(params)
    g = {k: torch.from_numpy(v) for k, v in _grads_np(3).items()}
    _, state, tel = _torch_update_with_stats(topt, g, state, params)
    for path, st in tel.items():
        ef = state.leaves[0]["lowrank"][path].ef
        np.testing.assert_allclose(
            st.ef_norm.numpy(),
            torch.linalg.vector_norm(ef, dim=(-2, -1)).numpy(), rtol=1e-5)


class _OpLog(TorchDispatchMode):
    """Every aten op the update dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _bits(tree) -> list:
    from repro_torch.train.checkpoint import tree_items
    return [(p, x.numpy().tobytes() if isinstance(x, torch.Tensor) else x)
            for p, x in tree_items(tree)]


@pytest.mark.parametrize("name,kw", [
    ("dct_adamw", {"fused": "on"}), ("dct_adamw", {"fused": "off"}),
    ("dct_adamw", {"fused": "fft", "update_interval": 2}),
    ("trion", {}), ("muon", {"rank": 16}), ("dion", {})])
def test_telemetry_reads_only(monkeypatch, name, kw):
    """With no collector the update runs exactly the ops of a rule that
    emits nothing (``emit_stats=False`` under a collector: no stat op, no
    collector lookup that runs an op); with a collector the update and the
    new state are bit-equal to those without."""
    kw = dict(kw, rank=kw.get("rank", R))
    topt = get_optimizer(name, lr=0.01, **kw)
    params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
    state = topt.init(params)
    runs = {}
    for tag in ("off", "on"):
        s = state
        logs = []
        for step in range(1, 3):
            g = {k: torch.from_numpy(v) for k, v in _grads_np(step).items()}
            with _OpLog() as log:
                if tag == "on":
                    u, s, tel = _torch_update_with_stats(topt, g, s, params)
                    assert set(tel) == set(LEAVES)
                else:
                    u, s = topt.update(g, s, params)
            logs.append(log.ops)
        runs[tag] = (logs, _bits(u), _bits(s))
    assert runs["on"][1:] == runs["off"][1:]
    assert runs["on"][0] != runs["off"][0]          # the stats ran ops
    # a rule with emit_stats=False under a collector: the same ops as none
    orig = ttf.lowrank_project
    monkeypatch.setattr(ttf, "lowrank_project", lambda rule, **k: orig(
        dataclasses.replace(rule, emit_stats=False), **k))
    quiet_opt = get_optimizer(name, lr=0.01, **kw)
    s = state
    logs = []
    for step in range(1, 3):
        g = {k: torch.from_numpy(v) for k, v in _grads_np(step).items()}
        with _OpLog() as log:
            _, s, tel = _torch_update_with_stats(quiet_opt, g, s, params)
        assert tel == {}
        logs.append(log.ops)
    assert logs == runs["off"][0]


def test_emit_stats_false_records_nothing():
    from repro_torch.optim.common import Context
    from repro_torch.optim.projected_adam import ProjectedAdamRule
    rule = ProjectedAdamRule(rank=R, fused="fft", emit_stats=False)
    with tstats.collect() as col:
        state = rule.init((24, 40), torch.float32)
        ctx = Context(step=1, bases={"24": dct2_matrix(24)},
                      stats=col.scope("w"))
        rule.update(torch.ones(24, 40), state, torch.zeros(24, 40), ctx)
    assert col.tree() == {}


def test_no_collector_outside_collect():
    assert tstats.active_collector() is None
    with tstats.collect() as outer:
        with tstats.collect() as inner:
            assert tstats.active_collector() is inner
        assert tstats.active_collector() is outer
    assert tstats.active_collector() is None


# ---------------------------------------------------------------------------
# the train step and the Trainer
# ---------------------------------------------------------------------------
def _smoke_pair(rank=16, **kw):
    jopt = jax_get_optimizer("dct_adamw", lr=0.01, rank=rank, **kw)
    topt = get_optimizer("dct_adamw", lr=0.01, rank=rank, **kw)
    jparams = JT.init_params(JAX_CFG, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jopt, topt, jparams, tparams


@pytest.mark.parametrize("fused", ["off", "fft"])
@pytest.mark.parametrize("guard", [False, True])
def test_train_step_metrics_telemetry_match_jax(fused, guard):
    jopt, topt, jparams, tparams = _smoke_pair(fused=fused)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    tstate = TS.TrainState(0, tparams, topt.init(tparams))
    jstep = jax.jit(JS.make_train_step(JAX_CFG, jopt, telemetry=True,
                                       guard=guard))
    tstep = TS.make_train_step(CFG, topt, telemetry=True, guard=guard)
    plain = TS.make_train_step(CFG, topt, guard=guard)
    for i in range(2):
        b = _batch(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        ref, rm = plain(tstate, tb)
        tstate, tm = tstep(tstate, tb)
        assert set(tm) == set(jm)
        assert set(tm["telemetry"]) == {
            f"segments/0/p0/{k}/kernel" for k in (
                "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wg",
                "mlp/wu", "mlp/wd")}
        _assert_stats_close(tm["telemetry"], jm["telemetry"], f"step {i}")
        # telemetry on: the same new state and loss as off, bit for bit
        assert _bits(tstate) == _bits(ref)
        assert float(tm["loss"]) == float(rm["loss"])


def test_train_step_telemetry_with_bf16_accumulation():
    _, topt, _, tparams = _smoke_pair(fused="off")
    state = TS.TrainState(0, tparams, topt.init(tparams))
    tb = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    on, m = TS.make_train_step(CFG, topt, accum_dtype="bfloat16",
                               telemetry=True)(state, tb)
    off, _ = TS.make_train_step(CFG, topt, accum_dtype="bfloat16")(state, tb)
    assert _bits(on) == _bits(off)
    assert len(m["telemetry"]) == 7
    for st in m["telemetry"].values():
        assert all(torch.isfinite(t).all() for t in st)


def test_to_host_is_one_copy_of_the_whole_tree(monkeypatch):
    g = torch.Generator().manual_seed(0)
    tree = {f"l{i}": tstats.SubspaceStats(*(torch.rand((3,), generator=g)
                                            for _ in FIELDS))
            for i in range(4)}
    tree["scalar"] = tstats.SubspaceStats(*(torch.rand((), generator=g)
                                            for _ in FIELDS))
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        copies.append(self.numel()), real_cpu(self, *a, **k))[1])
    host = tstats.to_host(tree)
    assert copies == [4 * 3 * 5 + 5]
    for path, st in tree.items():
        for t, h in zip(st, host[path]):
            assert isinstance(h, np.ndarray) and h.shape == tuple(t.shape)
            np.testing.assert_array_equal(h, t.numpy())


def test_summarize_matches_jax():
    rng = np.random.default_rng(1)
    vals = [rng.random(5).astype(np.float32) for _ in FIELDS]
    want = jstats.summarize(jstats.SubspaceStats(*map(jnp.asarray, vals)))
    assert tstats.summarize(tstats.SubspaceStats(*vals)) == want


def _trainer(opt, **kw):
    from repro_torch.data.synthetic import make_batch_fn
    return Trainer(train_step=TS.make_train_step(CFG, opt, telemetry=True),
                   init_state_fn=lambda: TS.init_state(CFG, opt, seed=0),
                   batch_fn=make_batch_fn(CFG, 16, 2, seed=0),
                   log_every=100, log_fn=QUIET, **kw)


def test_trainer_copies_telemetry_once_and_shares_it(monkeypatch):
    """With a sink and a controller hook the Trainer hands both the same
    host copy, made once a step; metrics_history keeps the scalars."""
    from repro_torch.train import loop
    opt = get_optimizer("dct_adamw", lr=0.01, rank=16)
    calls, seen = [], []
    real = loop.to_host
    monkeypatch.setattr(loop, "to_host",
                        lambda t: (calls.append(1), real(t))[1])

    def hook(step, state, metrics):
        seen.append(("hook", step, metrics["telemetry"]))

    def sink(record):
        seen.append(("sink", record["step"], record["telemetry"]))

    trainer = _trainer(opt, control_hook=hook, log_metrics=sink)
    trainer.run(total_steps=3)
    assert len(calls) == 3
    for step in (1, 2, 3):
        (_, _, a), (_, _, b) = [x for x in seen if x[1] == step]
        assert a is b and len(a) == 7
        for st in a.values():
            assert all(isinstance(f, np.ndarray) for f in st)
    assert all("telemetry" not in h for h in trainer.metrics_history)
    assert [h["step"] for h in trainer.metrics_history] == [1, 2, 3]


def test_trainer_without_hooks_leaves_telemetry_on_the_device(monkeypatch):
    from repro_torch.train import loop
    calls = []
    monkeypatch.setattr(loop, "to_host", lambda t: calls.append(1))
    trainer = _trainer(get_optimizer("dct_adamw", lr=0.01, rank=16))
    trainer.run(total_steps=2)
    assert calls == []
    assert all("telemetry" not in h for h in trainer.metrics_history)


# ---------------------------------------------------------------------------
# the selection helpers
# ---------------------------------------------------------------------------
def test_index_overlap_and_topr_margin_match_jax():
    rng = np.random.default_rng(4)
    a = np.sort(rng.permutation(40)[:8]).astype(np.int32)
    b = np.stack([a, np.sort(rng.permutation(40)[:8]).astype(np.int32)])
    np.testing.assert_array_equal(
        tsel.index_overlap(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jsel.index_overlap(jnp.asarray(a), jnp.asarray(b))))
    norms = rng.random((3, 40)).astype(np.float32)
    for r in (1, 8, 39, 40):
        np.testing.assert_allclose(
            tsel.topr_margin(torch.from_numpy(norms), r).numpy(),
            np.asarray(jsel.topr_margin(jnp.asarray(norms), r)), rtol=1e-6)


@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24)])
def test_reconstruction_error_sq_matches_jax(shape):
    g = planted(shape, 7)
    n = shape[-1]
    idx = np.sort(np.random.default_rng(2).permutation(n)[:R]).astype(np.int32)
    idx = np.broadcast_to(idx, (*shape[:-2], R)).copy()
    want = jsel.reconstruction_error_sq(jnp.asarray(g), jax_dct2(n),
                                        jnp.asarray(idx))
    got = reconstruction_error_sq(torch.from_numpy(g), dct2_matrix(n),
                                  torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the identity: ||G - G Q_r Q_r^T||^2 from the reconstruction itself
    q = dct2_matrix(n).double()
    gd = torch.from_numpy(g).double()
    qr = q[:, torch.from_numpy(idx).long()]
    if qr.dim() > 2:
        qr = qr.permute(1, 0, 2)
    resid = gd - gd @ qr @ qr.mT
    np.testing.assert_allclose(got.numpy(), (resid ** 2).sum((-2, -1)),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------
def _records(n, seed=0):
    """Per-step records as numpy: stacked and scalar stats, sentinels on
    alternate steps, and a metric that appears from step 3 on."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(1, n + 1):
        keep = step % 2 == 0
        stats = {}
        for path, shape in (("segments/0/p0/attn/wq/kernel", (3,)),
                            ("w", ())):
            f = rng.random((5, *shape)).astype(np.float32)
            if keep:
                f[1] = f[2] = -1.0
            stats[path] = f
        rec = {"step": step, "s_per_step": float(rng.random()),
               "loss": np.float32(rng.random() * 5), "telemetry": stats}
        if step >= 3:
            rec["grad_norm"] = np.float32(rng.random())
        out.append(rec)
    return out


def _as(rec, to_array, stats_cls):
    return {k: ({p: stats_cls(*map(to_array, f)) for p, f in v.items()}
                if k == "telemetry" else
                (to_array(v) if isinstance(v, np.floating) else v))
            for k, v in rec.items()}


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
@pytest.mark.parametrize("every", [1, 3, 4])
def test_sink_files_byte_identical_to_jax(tmp_path, fmt, every):
    """Full and partial buckets (7 records), sentinel-aware means, stacked
    lists (CSV collapses them), a key that appears late, and a resumed
    append; the port's records carry tensors, JAX's jax arrays."""
    recs = _records(7)
    files = {}
    for tag, mod, arr, cls in (
            ("jax", jsink, jnp.asarray, jstats.SubspaceStats),
            ("torch", tsink, torch.from_numpy, tstats.SubspaceStats)):
        path = str(tmp_path / f"{tag}.{fmt}")
        with mod.TelemetrySink(path, fmt=fmt, every=every) as s:
            for r in recs[:5]:
                s.log_metrics(_as(r, arr if tag == "jax" else
                                  (lambda x: torch.from_numpy(np.asarray(x))),
                                  cls))
            hist = s.history()
        # a resumed run appends to the file
        with mod.TelemetrySink(path, fmt=fmt, every=every, append=True) as s:
            for r in recs[5:]:
                s.log_metrics(_as(r, arr if tag == "jax" else
                                  (lambda x: torch.from_numpy(np.asarray(x))),
                                  cls))
        files[tag] = (open(path, "rb").read(), hist)
    assert files["torch"][0] == files["jax"][0]
    assert files["torch"][1] == files["jax"][1]
    if fmt == "jsonl":
        rows = [json.loads(x) for x in files["torch"][0].splitlines()]
        assert rows[-1]["step"] == 7.0


def test_sink_sentinel_aware_means():
    """A bucket of one refresh and three keep steps reports the refresh's
    margin, not a mean with the sentinels; an all-keep bucket stays -1."""
    def rec(step, margin):
        f = [np.float32(x) for x in (0.5, margin, margin, 1.0, 0.8)]
        return {"step": step, "telemetry": {
            "w": tstats.SubspaceStats(*map(torch.tensor, f))}}

    s = tsink.TelemetrySink(None, every=4)
    s.log_metrics(rec(1, 0.4))
    for step in range(2, 9):
        s.log_metrics(rec(step, -1.0))
    rows = s.history()
    assert rows[0]["telemetry/w/topr_margin"] == pytest.approx(0.4)
    assert rows[1]["telemetry/w/index_overlap"] == -1.0
    assert rows[0]["telemetry/w/captured_energy"] == pytest.approx(0.5)


def test_sink_rejects_bad_settings():
    with pytest.raises(ValueError, match="format"):
        tsink.TelemetrySink(None, fmt="parquet")
    with pytest.raises(ValueError, match="every"):
        tsink.TelemetrySink(None, every=0)
