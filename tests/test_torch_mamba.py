"""The Mamba family in the port against the JAX package: the mixer
(``models/mamba.py``) and jamba-1.5-large-398b at its smoke config (d=128,
one super-block of 8 layers: 7 Mamba layers, 4 of them with the MoE FFN of
8 experts top-2 and no shared experts, and one ``attn`` layer; d_inner
256, SSM state 16, dt rank 8, fp32).

Parameters are drawn by numpy into JAX's tree (``torch_recurrent_parity``)
and carried over by ``convert``. The bars: the mixer's outputs and final
state at rtol 1e-5 of max |out| (fp32, the log-depth scan's products in
the reference's order, the einsums' sums in another), its gradients at
1e-4; the model's logits at ``P.TOL``, ``moe_aux`` and the losses at rtol
1e-5 and every gradient at rtol 1e-4 of the leaf's max |grad| (the bars of
``test_torch_model_train.py``); prefill + decode against the forward and
JAX's at ``P.TOL`` (the caches with its atol taken relative to each
entry's max |x|: a Mamba layer's conv tail is its input's projection, of
entries up to ~4, whose small ones carry the stack's fp32 sums in
absolute terms); greedy streams token for
token; 5-step DCT-AdamW trajectories at ``TRAJECTORY_RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse
import torch_dense_parity as P
import torch_recurrent_parity as R

from repro.configs import jamba15_large_398b as jax_jamba
from repro.models import mamba as JMB
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine
from repro_torch.train import steps as TS

ARCH = "jamba-1.5-large-398b"
JCFG = jax_jamba.SMOKE
CFG = get_config(ARCH, smoke=True)
#: the prompt of the forward, prefill and decode comparisons
SEQ = 24
#: the mixer alone: outputs and state, gradients
MIX_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def model():
    """(jax params, port params) of the smoke config."""
    return R.pair(JCFG, seed=3)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba block's ``mamba`` subtree of JAX's parameters and the
    port's flat copy."""
    jp, _ = R.pair(dataclasses.replace(JCFG, schedule=((("mamba_dense",),
                                                        1),)), seed=5)
    jm = jax.tree.map(lambda a: a[0], jp["segments"][0]["p0"]["mamba"])
    return jm, convert.params_from_jax(jax.tree.map(np.asarray, jm),
                                       device="cpu")


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


def test_configs_match_jax():
    P.configs_match(ARCH, jax_jamba)
    assert CFG.family == "hybrid" and set(CFG.block_kinds()) <= \
        set(TT.PORTED_KINDS)
    assert (CFG.mamba_dt_rank, CFG.dt_rank, CFG.mamba_d_inner) == (8, 8, 256)
    assert CFG.n_shared_experts == 0 and CFG.shared_d_ff == 0
    full = get_config(ARCH)
    assert (full.dt_rank, full.mamba_d_inner, full.n_layers) == \
        (512, 16384, 72)


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_jamba)
    assert 398e9 < n < 399e9


def test_full_config_labels_match_jax():
    """``default_label_fn`` over the full config's leaves equals JAX's: the
    stacked (9, 16384) ``d_skip`` of each Mamba position is a matrix (n =
    9), the router (72 layers' (8192, 16)) too; ``a_log``, the conv, the
    dt projection and the norms stay full-rank."""
    labels = R.labels_match(ARCH, jax_jamba)
    assert labels["segments/0/p0/mamba/d_skip"] == "lowrank"
    assert labels["segments/0/p1/moe/router/kernel"] == "lowrank"
    assert labels["segments/0/p0/mamba/x_proj/kernel"] == "lowrank"
    for leaf in ("a_log", "conv/kernel", "dt_proj/kernel", "dt_proj/bias"):
        assert labels[f"segments/0/p0/mamba/{leaf}"] == "full", leaf


def test_init_params_match_jax_leaves(model):
    P.smoke_leaves_match(model[0], CFG)


@pytest.mark.parametrize("s", [6, 128, 256])
def test_mamba_mix_matches_jax(mixer, s):
    """Outputs and the decode state (``return_state``) at S = 6 (one short
    chunk), 128 (one full chunk) and 256 (two: the carry between chunks),
    and the gradient of ``sum(out * w)`` with respect to every leaf and
    x."""
    jm, tm = mixer
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, JCFG.d_model)).astype(np.float32)
    w = rng.standard_normal((2, s, JCFG.d_model)).astype(np.float32)

    def loss(p, x):
        out, state = JMB.mamba_mix(p, x, JCFG, return_state=True)
        return jnp.sum(out * w), (out, state)

    (_, (jout, jstate)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jm, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tm.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, tstate = TMB.mamba_mix(leaves, tx, CFG, return_state=True)
    _close(tout, jout, MIX_RTOL)
    assert set(tstate) == {"conv", "ssm"} and tstate["ssm"].dtype == \
        torch.float32
    for k in tstate:
        _close(tstate[k], jstate[k], MIX_RTOL, k)
    torch.sum(tout * torch.from_numpy(w)).backward()
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgp),
                                   device="cpu")
    for k, v in leaves.items():
        _close(v.grad, want[k], GRAD_RTOL, k)
    _close(tx.grad, jgx, GRAD_RTOL, "x")


def test_mamba_mix_refuses_a_ragged_sequence(mixer):
    """The reference's rule ``S % min(128, S) == 0``: 130 positions raise,
    nothing is padded."""
    x = torch.zeros((1, 130, CFG.d_model))
    with pytest.raises(ValueError, match="multiple of the scan chunk 128"):
        TMB.mamba_mix(mixer[1], x, CFG)


def test_associative_scan_is_the_sequential_recurrence():
    """The log-depth scan of ``h' = a h + b`` equals the loop over
    positions at every length (odd and even levels)."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 5, 8, 13, 128):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3)))
        b = torch.from_numpy(rng.standard_normal((2, n, 3)))
        a_cum, h = TMB.associative_scan([a, b], axis=1)
        ha, hb = torch.ones(2, 3, dtype=a.dtype), torch.zeros(2, 3,
                                                               dtype=a.dtype)
        for t in range(n):
            ha, hb = ha * a[:, t], a[:, t] * hb + b[:, t]
            torch.testing.assert_close(a_cum[:, t], ha)
            torch.testing.assert_close(h[:, t], hb)


def test_mamba_step_matches_mix_and_jax(mixer):
    """``mamba_step`` run over 16 positions from a zero cache gives
    ``mamba_mix``'s outputs and final state, and JAX's steps."""
    jm, tm = mixer
    x = np.random.default_rng(7).standard_normal(
        (2, 16, JCFG.d_model)).astype(np.float32)
    mix, state = TMB.mamba_mix(tm, torch.from_numpy(x), CFG,
                               return_state=True)
    cache = TMB.init_mamba_cache(CFG, 2, torch.float32, "cpu")
    jcache = JMB.init_mamba_cache(JCFG, 2, jnp.float32)
    jstep = jax.jit(lambda p, xt, c: JMB.mamba_step(p, xt, c, JCFG))
    for t in range(16):
        y, cache = TMB.mamba_step(tm, torch.from_numpy(x[:, t]), cache, CFG)
        jy, jcache = jstep(jm, jnp.asarray(x[:, t]), jcache)
        _close(y, mix[:, t].detach().numpy(), MIX_RTOL, f"position {t}")
        _close(y, jy, MIX_RTOL, f"position {t}")
    for k in ("conv", "ssm"):
        _close(cache[k], state[k].detach().numpy(), MIX_RTOL, k)
        _close(cache[k], jcache[k], MIX_RTOL, k)


def test_logits_aux_loss_grads_match_jax(model, jfn):
    """Logits, ``moe_aux``, the loss and the gradient of every leaf."""
    jp, tp = model
    toks = _tokens(0)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jaux = jfn["forward"](jp, jnp.asarray(batch["tokens"], jnp.int32))
    tl, taux = TT.forward(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                          CFG)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **P.TOL)
    assert float(jaux["moe_aux"]) > 0 and taux["mtp_logits"] is None
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)
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
    (logits and every cache entry: the attention layer's K / V, each Mamba
    layer's conv tail and fp32 SSM state)."""
    jp, tp = model
    toks = _tokens(1, SEQ)
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, CFG)
    n = SEQ - 4
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :n])}, CFG, max_len=SEQ + 4)
    jlast, jcache = jfn["prefill"](jp, jnp.asarray(toks[:, :n], jnp.int32))
    assert {key.rsplit("/", 1)[1] for key in cache} == {"k", "v", "conv",
                                                        "ssm"}
    assert cache["segments/0/p0/ssm"].dtype == torch.float32
    steps = [(last, jlast)]
    for i in range(n, SEQ):
        tok = toks[:, i]
        want_cache = convert.pools_from_jax(jax.tree.map(np.asarray, jcache),
                                            device="cpu")
        assert set(want_cache) == set(cache)
        for key, want in want_cache.items():
            want = want.numpy()
            np.testing.assert_allclose(
                cache[key].numpy(), want, rtol=P.TOL["rtol"],
                atol=P.TOL["atol"] * np.abs(want).max(), err_msg=key)
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


def test_five_step_dct_adamw_trajectory_matches_jax():
    """5 DCT-AdamW steps of one ``mamba_moe`` layer at the smoke widths
    (the mixer and the MoE without shared experts) against JAX's at
    ``TRAJECTORY_RTOL`` (measured 4.6e-6). Not of the whole 8-layer smoke
    model: its two packages' fp32 gradients part by up to 5e-5 of max |g|,
    and Adam's sign-like first step, the top-16 reselection and the
    routers turn that into loss gaps that grow with depth (measured at
    step 4: 3.3e-3 at 8 layers, 2.8e-4 at ``mamba_dense, mamba_moe,
    attn``, 4.5e-4 at ``mamba_dense, mamba_moe``; 7.6e-6 at one
    ``mamba_dense``); ``test_deep_mamba_trajectory_routes_d_skip_low_rank``
    holds 8 layers on shared gradients."""
    sched = ((("mamba_moe",), 1),)
    jcfg = dataclasses.replace(JCFG, schedule=sched)
    tcfg = dataclasses.replace(CFG, schedule=sched)
    tl, jl = R.trajectory(jcfg, tcfg, *R.pair(jcfg, seed=3))
    np.testing.assert_allclose(tl, jl, rtol=R.TRAJECTORY_RTOL)
    assert tl[-1] < tl[0]


def test_deep_mamba_trajectory_routes_d_skip_low_rank(monkeypatch):
    """Eight stacked ``mamba_dense`` layers: the (8, 256) ``d_skip`` is a
    low-rank leaf with n = 8 in both packages (the reference's labelling of
    a stacked vector), and 5 DCT-AdamW steps follow JAX's
    (``R.deep_routing``)."""
    R.deep_routing(*R.deep(JCFG, ARCH, "mamba_dense"), monkeypatch,
                   ("mamba/d_skip",))


def test_moe_without_shared_experts_drops_like_jax(model):
    """jamba's MoE FFN has no shared experts: with capacity factor 1.25
    and inputs crowded onto a few experts some pairs overflow (asserted);
    outputs and aux at rtol 1e-5, gradients at 1e-4, as JAX's."""
    jcfg = dataclasses.replace(JCFG, capacity_factor=1.25)
    tcfg = dataclasses.replace(CFG, capacity_factor=1.25)
    jmoe = jax.tree.map(lambda a: a[0], model[0]["segments"][0]["p1"]["moe"])
    tmoe = convert.params_from_jax(jax.tree.map(np.asarray, jmoe),
                                   device="cpu")
    assert "shared/wg" not in tmoe
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, JCFG.d_model)).astype(np.float32)
    x += 3.0 * rng.standard_normal(JCFG.d_model).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, JCFG.d_model)
                          @ tmoe["router/kernel"], -1)
    top = torch.sort(probs, -1, descending=True).values
    assert float((top[:, :2] - top[:, 1:3]).min()) > 1e-5   # order kept
    _, gate_e = TM.top_k(probs, 2)
    counts = torch.bincount(gate_e.reshape(-1), minlength=JCFG.n_experts)
    assert int(counts.max()) > TM.capacity(32, tcfg)

    def loss(p, x):
        y, aux = JM.moe_ffn(p, x, jcfg)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jmoe, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tmoe.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TM.moe_ffn(leaves, tx, tcfg)
    _close(ty, jy, 1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    (torch.sum(ty * torch.from_numpy(w)) + taux).backward()
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgp),
                                   device="cpu")
    for k, v in leaves.items():
        _close(v.grad, want[k], GRAD_RTOL, k)
    _close(tx.grad, jgx, GRAD_RTOL, "x")


@pytest.mark.parametrize("engine", ["dense", "train"])
def test_clis_run_on_cpu(engine):
    P.cli_runs(ARCH, engine)
