"""Checks shared by the parity tests of the recurrent families
(``test_torch_mamba.py``: jamba-1.5-large-398b; ``test_torch_rwkv.py``:
rwkv6-1.6b): the port against the JAX package on the same numpy-seeded
parameters and inputs, at the smoke configs (fp32).

Parameters are drawn by ``torch_dense_parity.pair`` with ``special`` for
the leaves whose init is a constant the generic rule would leave
degenerate: the layer norms' scales (1 + N(0, 0.1^2)) and biases, the
token-shift mixes ``mu_*`` (U(0, 1)), the decay's ``decay_w0`` (U(-3,
-1)), ``bonus_u``, Mamba's ``a_log`` (log U(1, 16)), ``d_skip`` and the
dt bias (N(-3, 0.5^2): dt near 0.05, so the SSM state carries across
positions and chunks rather than decaying in one step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_dense_parity as P

from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.optim.common import labelled_tree as jax_labelled_tree
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT
from repro_torch.optim.api import get_optimizer
from repro_torch.optim.common import labelled_tree
from repro_torch.serve import ServeEngine
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup

#: 5 DCT-AdamW steps at rank 16 on the JAX package's synthetic batches
#: (the setting of ``test_torch_deepseek.py``); fp32 sums in other orders
#: amplified by the top-r reselection and the int8 EF rounding
TRAJECTORY_RTOL = 1e-4


def special(path: str, shape, rng):
    """The draws of the leaves named in the module docstring, else None."""
    name = path.rsplit("/", 1)[-1]
    if name.startswith("mu_"):
        return rng.uniform(0.0, 1.0, shape)
    if name == "decay_w0":
        return rng.uniform(-3.0, -1.0, shape)
    if name == "bonus_u":
        return rng.normal(0.0, 0.5, shape)
    if name == "ln_scale" or path.endswith(("ln1/scale", "ln2/scale")):
        return 1.0 + rng.normal(0.0, 0.1, shape)
    if path.endswith(("ln1/bias", "ln2/bias")):
        return rng.normal(0.0, 0.1, shape)
    if name == "a_log":
        return np.log(rng.uniform(1.0, 16.0, shape))
    if name == "d_skip":
        return rng.normal(1.0, 0.2, shape)
    if path.endswith("dt_proj/bias"):
        return rng.normal(-3.0, 0.5, shape)
    return None


def pair(jax_cfg, seed: int = 0):
    return P.pair(jax_cfg, seed=seed, special=special)


def labels_match(arch: str, jax_module) -> dict:
    """The port's ``labelled_tree`` of the full config on ``device="meta"``
    against JAX's ``labelled_tree`` of ``jax.eval_shape``, leaf for leaf.
    Returns the port's ``{path: label}``."""
    jtree = jax.eval_shape(lambda: JT.init_params(
        jax_module.CONFIG, jax.random.PRNGKey(0)))
    want = {P._path(kp): label for kp, label in
            jax.tree_util.tree_flatten_with_path(jax_labelled_tree(jtree))[0]}
    got = labelled_tree(TT.init_params(get_config(arch), 0, "meta"))
    assert got == want
    return got


def oracle_stream(jparams, tparams, jcfg, tcfg, forward, *, s: int = 6,
                  new: int = 4) -> None:
    """The port's ``ServeEngine.generate`` (greedy) equal to the oracle of
    JAX's ``test_serve_families.py::test_generate_matches_stepwise_forward``:
    argmax over repeated full forwards of JAX's model, the sequence grown by
    one token each time. ``forward(params, tokens) -> logits``: JAX's, run
    at one length (s + new - 1, the tokens past the grown sequence zero):
    the model is causal (a position's logits read no later token; the smoke
    MoE drops none), so each step's logits are those of the grown sequence,
    from one compile of JAX's model."""
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, s))
    got = ServeEngine(tcfg, tparams, max_len=s + new).generate(
        {"tokens": torch.from_numpy(toks)}, max_new_tokens=new)
    seq = np.zeros((2, s + new - 1), np.int32)
    seq[:, :s] = toks
    for t in range(s, s + new):
        logits = forward(jparams, jnp.asarray(seq))
        nxt = np.asarray(jnp.argmax(logits[:, t - 1], axis=-1))
        if t < s + new - 1:
            seq[:, t] = nxt
    want = np.concatenate([seq[:, s:], nxt[:, None]], axis=1)
    assert got.tolist() == want.tolist()


#: the trajectories' optimizer (lr: the peak of a cosine warmup of 2 steps)
_OPT = dict(rank=16, weight_decay=0.01)
_LR, _WARMUP = 0.01, 2


def _batches(tcfg, steps: int):
    data = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16,
                       global_batch=4)
    return [{k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
            for i in range(steps)]


def port_losses(tcfg, tp, *, steps: int = 5) -> list:
    """The port's own ``steps`` DCT-AdamW steps (``trajectory``'s)."""
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(_LR, _WARMUP, steps),
                         **_OPT)
    tstate = TS.TrainState(0, tp, topt.init(tp))
    tstep = TS.make_train_step(tcfg, topt)
    out = []
    for b in _batches(tcfg, steps):
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        out.append(float(tm["loss"]))
    return out


def trajectory(jcfg, tcfg, jp, tp, *, steps: int = 5, on_step=None,
               batches=None):
    """``steps`` DCT-AdamW steps of both packages from the same parameters
    on the same batches (rank 16, lr 0.01, cosine warmup 2, weight decay
    0.01): the JAX package's synthetic token batches, or ``batches`` (numpy
    dicts, one a step). ``on_step(port params, JAX params)`` after each
    step. Returns (the port's losses, JAX's)."""
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(_LR, _WARMUP, steps),
                             **_OPT)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(_LR, _WARMUP, steps),
                         **_OPT)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    tstate = TS.TrainState(0, tp, topt.init(tp))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    jl, tl = [], []
    for b in batches or _batches(tcfg, steps):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if on_step is not None:
            on_step(tstate.params, jstate.params)
    return tl, jl


def deep_routing(jcfg, tcfg, jp, tp, monkeypatch, leaves) -> None:
    """The deep configs' routing check. ``leaves`` (stacked vectors of
    (8, width)) are low-rank with n = 8 in both packages' labels. Then 5
    DCT-AdamW steps twice: (a) both packages' train steps on the same
    gradients, JAX's model's at JAX's parameters of each step (each
    package's ``train.steps.grad_fn`` patched to return them): the routed
    leaves (r = n = 8: every column, no selection) and every full-rank
    leaf within 1e-5 of its max |p| after each step, so the projected
    updates of those leaves follow the reference's; (b) the port's own
    train step: finite losses, the first within 1e-5 of JAX's, the last
    below the first.

    Why (a) shares the gradients: at 8 random layers the two packages'
    fp32 gradients part by up to ~3e-4 of max |g| (JAX's own are ~1e-4 from
    a float64 run of the port), and Adam's first, sign-like step and the
    top-r reselection turn that into loss differences of 1e-3 by step 3
    (measured at lr 0.01 and 0.001, ranks 16 and 128, and with the residual
    branches scaled down) in either package's own fp32. The wide matrices
    are not held: on the same gradients their top-16 of 128 columns can
    still part at a near-tie of two column norms (one column of one matrix
    measured, 9e-4 of its max |p|), which the smoke depth's trajectories
    cover."""
    want = {P._path(kp): label for kp, label in
            jax.tree_util.tree_flatten_with_path(jax_labelled_tree(jp))[0]}
    got = labelled_tree(tp)
    assert got == want
    for leaf in leaves:
        path = f"segments/0/p0/{leaf}"
        assert tuple(tp[path].shape)[0] == 8 and tp[path].dim() == 2
        assert got[path] == "lowrank", leaf

    checked = {k for k, label in got.items() if label == "full"} | \
        {f"segments/0/p0/{leaf}" for leaf in leaves}
    steps = 5
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(_LR, _WARMUP, steps),
                             **_OPT)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(_LR, _WARMUP, steps),
                         **_OPT)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    tstate = TS.TrainState(0, tp, topt.init(tp))
    grad_fn = JS.grad_fn                 # the model's, before the patch
    jgrad = jax.jit(lambda p, b: grad_fn(p, b, jcfg))
    shared = {}
    with monkeypatch.context() as m:
        # both train steps take the step's gradients as given: JAX's
        # through the batch (its grad_fn is read when the step is traced),
        # the port's from ``shared``
        m.setattr(JS, "grad_fn", lambda params, batch, cfg: (
            batch["grads"], batch["metrics"]))
        m.setattr(TS, "grad_fn", lambda params, batch, cfg: shared["g"])
        jstep = jax.jit(JS.make_train_step(jcfg, jopt))
        tstep = TS.make_train_step(tcfg, topt)
        jl = []
        for b in _batches(tcfg, steps):
            jb = jax.tree.map(jnp.asarray, b)
            g, metrics = jgrad(jstate.params, jb)
            shared["g"] = (
                convert.params_from_jax(jax.tree.map(np.asarray, g),
                                        device="cpu"),
                {k: torch.tensor(float(v)) for k, v in metrics.items()})
            jstate, _ = jstep(jstate, {**jb, "grads": g, "metrics": metrics})
            tstate, _ = tstep(tstate, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
            jl.append(float(metrics["loss"]))
            for path, ref in convert.params_from_jax(
                    jax.tree.map(np.asarray, jstate.params),
                    device="cpu").items():
                if path in checked:
                    ref = ref.numpy()
                    np.testing.assert_allclose(
                        tstate.params[path].numpy(), ref, rtol=1e-5,
                        atol=1e-5 * np.abs(ref).max(), err_msg=path)
    own = port_losses(tcfg, tp)
    assert all(np.isfinite(own)) and own[-1] < own[0]
    np.testing.assert_allclose(own[0], jl[0], rtol=1e-5)


def deep(jax_cfg, arch: str, kind: str, repeats: int = 8):
    """The smoke config of ``arch`` with one block ``kind`` stacked
    ``repeats`` deep, in both packages, with its pair of parameters:
    (jax cfg, port cfg, jax params, port params)."""
    sched = (((kind,), repeats),)
    jcfg = dataclasses.replace(jax_cfg, schedule=sched)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), schedule=sched)
    return (jcfg, tcfg, *pair(jcfg, seed=11))
