"""The RWKV-6 family in the port against the JAX package: the mixers
(``models/rwkv.py``) and rwkv6-1.6b at its smoke config (d=128, 2 ``rwkv``
layers, 4 WKV heads of 32, decay LoRA rank 8, fp32).

Parameters are drawn by numpy into JAX's tree (``torch_recurrent_parity``)
and carried over by ``convert``. The bars: the mixers' outputs and states
at rtol 1e-5 of max |out| (fp32; the WKV scan's per-token sums in another
order), their gradients at 1e-4; the model's logits at ``P.TOL``, the
losses at rtol 1e-5 and every gradient at rtol 1e-4 of the leaf's max
|grad| (the bars of ``test_torch_model_train.py``); prefill + decode
against the forward and JAX's at ``P.TOL``; greedy streams token for
token; 5-step DCT-AdamW trajectories at ``TRAJECTORY_RTOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse
import torch_dense_parity as P
import torch_recurrent_parity as R

from repro.configs import rwkv6_1p6b as jax_rwkv
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine
from repro_torch.train import steps as TS

ARCH = "rwkv6-1.6b"
JCFG = jax_rwkv.SMOKE
CFG = get_config(ARCH, smoke=True)
#: the prompt of the forward, prefill and decode comparisons
SEQ = 24
#: the mixers alone: outputs and states, gradients
MIX_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def model():
    """(jax params, port params) of the smoke config."""
    return R.pair(JCFG, seed=3)


@pytest.fixture(scope="module")
def mixers(model):
    """Layer 1's ``tm`` and ``cm`` subtrees of JAX's parameters and the
    port's flat copies."""
    block = jax.tree.map(lambda a: a[1], model[0]["segments"][0]["p0"])
    return {name: (block[name], convert.params_from_jax(
                jax.tree.map(np.asarray, block[name]), device="cpu"))
            for name in ("tm", "cm")}


@pytest.fixture(scope="module")
def jfn():
    """JAX's functions of the smoke model, jitted once for the module."""
    return {
        "forward": jax.jit(lambda p, toks: JT.forward(
            p, {"tokens": toks}, JCFG)),
        "grad": jax.jit(lambda p, b: jax.value_and_grad(
            JS.loss_fn, has_aux=True)(p, b, JCFG)),
        "prefill": jax.jit(lambda p, toks: JT.prefill(
            p, {"tokens": toks}, JCFG, max_len=SEQ + 4)[:2]),
        "decode": jax.jit(lambda p, c, tok, pos: JT.decode_step(
            p, c, tok, pos, JCFG)),
    }


def _tokens(seed, s=SEQ + 1):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (2, s))


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def _inputs(seed, s=12):
    """x (2, s, d), x_prev (2, d), a WKV state (2, H, K, V) and an output
    weight (2, s, d)."""
    rng = np.random.default_rng(seed)
    h, hs = JCFG.rwkv_n_heads, JCFG.rwkv_head_size
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((2, s, JCFG.d_model), (2, JCFG.d_model), (2, h, hs, hs),
                  (2, s, JCFG.d_model)))


def test_configs_match_jax():
    P.configs_match(ARCH, jax_rwkv)
    assert CFG.family == "ssm" and CFG.block_kinds() == ("rwkv",)
    assert (CFG.rwkv_head_size, CFG.rwkv_decay_lora, CFG.rwkv_n_heads) == \
        (32, 8, 4)
    full = get_config(ARCH)
    assert (full.rwkv_n_heads, full.n_layers, full.norm_eps) == \
        (32, 24, 1e-5)


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_rwkv)
    assert 1.58e9 < n < 1.59e9


def test_full_config_labels_match_jax():
    """``default_label_fn`` over the full config's leaves equals JAX's: the
    stacked (24, 2048) mixes ``mu_*`` are matrices (n = 24), and so is
    ``bonus_u`` (24 matrices of (32, 64)); the decay leaves, the norms and
    their biases stay full-rank."""
    labels = R.labels_match(ARCH, jax_rwkv)
    for leaf in ("tm/mu_r", "tm/mu_w", "cm/mu_c", "tm/bonus_u",
                 "tm/wr/kernel", "cm/cv/kernel"):
        assert labels[f"segments/0/p0/{leaf}"] == "lowrank", leaf
    for leaf in ("tm/decay_w0", "tm/decay_a", "tm/decay_b", "tm/ln_scale",
                 "ln1/scale", "ln1/bias"):
        assert labels[f"segments/0/p0/{leaf}"] == "full", leaf


def test_init_params_match_jax_leaves(model):
    P.smoke_leaves_match(model[0], CFG)


def test_layer_norm_matches_jax():
    from repro.models.layers import layer_norm as jax_layer_norm
    from repro_torch.models.layers import layer_norm
    rng = np.random.default_rng(0)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32)
                      for s in ((3, 5, 64), (64,), (64,)))
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias), 1e-5)
    got = layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5)
    _close(got, want, 1e-6)
    got = layer_norm(torch.from_numpy(x).bfloat16(),
                     *map(torch.from_numpy, (scale, bias)), 1e-5)
    assert got.dtype == torch.bfloat16


def test_time_mix_matches_jax(mixers):
    """Outputs, the last token and the WKV state from a given x_prev and
    state, and the gradient of ``sum(out * w)`` with respect to every leaf,
    x and the state."""
    jtm, ttm = mixers["tm"]
    x, xp, st, w = _inputs(1)

    def loss(p, x, st):
        out, last, new = JR.time_mix(p, x, jnp.asarray(xp), st, JCFG)
        return jnp.sum(out * w), (out, last, new)

    (_, jouts), (jgp, jgx, jgs) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jtm, jnp.asarray(x),
                                                jnp.asarray(st))
    leaves = {k: v.clone().requires_grad_(True) for k, v in ttm.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = torch.from_numpy(st).requires_grad_(True)
    touts = TR.time_mix(leaves, tx, torch.from_numpy(xp), tst, CFG)
    for got, want, name in zip(touts, jouts, ("out", "last", "state")):
        _close(got, want, MIX_RTOL, name)
    torch.sum(touts[0] * torch.from_numpy(w)).backward()
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgp),
                                   device="cpu")
    for k, v in leaves.items():
        _close(v.grad, want[k], GRAD_RTOL, k)
    _close(tx.grad, jgx, GRAD_RTOL, "x")
    _close(tst.grad, jgs, GRAD_RTOL, "state")


def test_channel_mix_matches_jax(mixers):
    jcm, tcm = mixers["cm"]
    x, xp, _, w = _inputs(2)

    def loss(p, x):
        out, last = JR.channel_mix(p, x, jnp.asarray(xp))
        return jnp.sum(out * w), (out, last)

    (_, jouts), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jcm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tcm.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    touts = TR.channel_mix(leaves, tx, torch.from_numpy(xp))
    for got, want in zip(touts, jouts):
        _close(got, want, MIX_RTOL)
    torch.sum(touts[0] * torch.from_numpy(w)).backward()
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgp),
                                   device="cpu")
    for k, v in leaves.items():
        _close(v.grad, want[k], GRAD_RTOL, k)
    _close(tx.grad, jgx, GRAD_RTOL, "x")


def test_steps_match_the_scan_and_jax(mixers):
    """``time_mix_step`` / ``channel_mix_step`` run over 12 tokens from the
    same x_prev and state give the sequence forms' outputs and final
    states, and JAX's steps."""
    (jtm, ttm), (jcm, tcm) = mixers["tm"], mixers["cm"]
    x, xp, st, _ = _inputs(3)
    tx = torch.from_numpy(x)
    seq_tm = TR.time_mix(ttm, tx, torch.from_numpy(xp), torch.from_numpy(st),
                         CFG)
    seq_cm = TR.channel_mix(tcm, tx, torch.from_numpy(xp))
    jstep = jax.jit(lambda tm, cm, xt, xp_tm, xp_cm, s: (
        JR.time_mix_step(tm, xt, xp_tm, s, JCFG),
        JR.channel_mix_step(cm, xt, xp_cm)))
    xp_tm = xp_cm = torch.from_numpy(xp)
    state = torch.from_numpy(st)
    jxp_tm = jxp_cm = jnp.asarray(xp)
    jst = jnp.asarray(st)
    for t in range(x.shape[1]):
        out, xp_tm, state = TR.time_mix_step(ttm, tx[:, t], xp_tm, state, CFG)
        cout, xp_cm = TR.channel_mix_step(tcm, tx[:, t], xp_cm)
        (jout, jxp_tm, jst), (jcout, jxp_cm) = jstep(
            jtm, jcm, jnp.asarray(x[:, t]), jxp_tm, jxp_cm, jst)
        _close(out, seq_tm[0][:, t].numpy(), MIX_RTOL, f"tm {t}")
        _close(out, jout, MIX_RTOL, f"tm {t}")
        _close(cout, seq_cm[0][:, t].numpy(), MIX_RTOL, f"cm {t}")
        _close(cout, jcout, MIX_RTOL, f"cm {t}")
    _close(state, seq_tm[2].numpy(), MIX_RTOL, "state")
    _close(state, jst, MIX_RTOL, "state")
    assert torch.equal(xp_tm, seq_tm[1]) and torch.equal(xp_cm, seq_cm[1])


def test_logits_loss_grads_match_jax(model, jfn):
    """Logits, the loss (``moe_aux`` is zero: no MoE) and the gradient of
    every leaf."""
    jp, tp = model
    toks = _tokens(0)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jaux = jfn["forward"](jp, jnp.asarray(batch["tokens"], jnp.int32))
    tl, taux = TT.forward(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                          CFG)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **P.TOL)
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    (_, jm), jg = jfn["grad"](jp, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.int32), batch))
    tg, tm = TS.grad_fn(tp, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, CFG)
    assert set(tm) == set(jm) == {"ce", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg),
                                   device="cpu")
    assert set(tg) == set(want)
    for path, g in tg.items():
        _close(g, want[path], 1e-4, path)


def test_prefill_decode_matches_forward_and_jax(model, jfn):
    """``prefill`` of SEQ - 4 tokens and 4 ``decode_step``s equal the
    forward's logits at those positions, and JAX's prefill and decode
    (logits and every cache entry: the last tokens of each mix and the
    fp32 WKV state)."""
    jp, tp = model
    toks = _tokens(1, SEQ)
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, CFG)
    n = SEQ - 4
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :n])}, CFG, max_len=SEQ + 4)
    jlast, jcache = jfn["prefill"](jp, jnp.asarray(toks[:, :n], jnp.int32))
    assert set(cache) == {f"segments/0/p0/{n}" for n in
                          ("x_prev_tm", "x_prev_cm", "wkv")}
    assert cache["segments/0/p0/wkv"].dtype == torch.float32
    assert tuple(cache["segments/0/p0/wkv"].shape) == (2, 2, 4, 32, 32)
    steps = [(last, jlast)]
    for i in range(n, SEQ):
        tok = toks[:, i]
        for key, want in convert.pools_from_jax(
                jax.tree.map(np.asarray, jcache), device="cpu").items():
            np.testing.assert_allclose(cache[key].numpy(), want.numpy(),
                                       **P.TOL, err_msg=key)
        with torch.inference_mode():
            lg, cache = TT.decode_step(tp, cache, torch.from_numpy(tok), i,
                                       CFG)
        jlg, jcache = jfn["decode"](jp, jcache, jnp.asarray(tok, jnp.int32),
                                    jnp.int32(i))
        steps.append((lg, jlg))
    for j, (got, want) in enumerate(steps):
        pos = n - 1 + j
        np.testing.assert_allclose(got.numpy(), full[:, pos].detach().numpy(),
                                   **P.TOL, err_msg=f"position {pos}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **P.TOL,
                                   err_msg=f"position {pos}")


def test_generate_matches_stepwise_forward_oracle(model, jfn):
    R.oracle_stream(*model, JCFG, CFG, lambda p, t: jfn["forward"](p, t)[0])


def test_paged_engine_refuses_with_jax_message(model):
    from repro_torch.launch import serve as serve_cli
    assert not TT.paged_supported(CFG)
    with pytest.raises(ValueError, match="use the dense ServeEngine"):
        PagedServeEngine(CFG, model[1])
    with pytest.raises(ValueError) as want:
        JT.init_paged_pools(JCFG, 4, 8)
    with pytest.raises(SystemExit) as got:
        serve_cli.run(serve_cli.build(["--arch", ARCH, "--smoke",
                                       "--device", "cpu"]))
    assert str(got.value) == str(want.value)


def test_five_step_dct_adamw_trajectory_matches_jax(model):
    tl, jl = R.trajectory(JCFG, CFG, *model)
    np.testing.assert_allclose(tl, jl, rtol=R.TRAJECTORY_RTOL)
    assert tl[-1] < tl[0]


def test_deep_rwkv_trajectory_routes_mixes_low_rank(monkeypatch):
    """Eight stacked ``rwkv`` layers: the (8, 128) mixes ``mu_*`` are
    low-rank leaves with n = 8 in both packages (the reference's labelling
    of stacked vectors), and 5 DCT-AdamW steps follow JAX's
    (``R.deep_routing``)."""
    R.deep_routing(*R.deep(JCFG, ARCH, "rwkv"), monkeypatch,
                   ("tm/mu_r", "tm/mu_k", "tm/mu_v", "tm/mu_g", "tm/mu_w",
                    "cm/mu_c"))


@pytest.mark.parametrize("engine", ["dense", "train"])
def test_clis_run_on_cpu(engine):
    P.cli_runs(ARCH, engine)
