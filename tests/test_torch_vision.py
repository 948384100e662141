"""llama-3.2-vision-90b, the cross-attention VLM, in the port against the
JAX package at its smoke config (d=128, one repeat of its pattern: 4
``attn`` layers and a ``cross`` layer, 4 / 2 heads of 32, 8 stub image
tokens, fp32), and its ``cross`` block with bf16 compute and bf16
parameters, the real config's precision: the fp32 gates widen the block's
output to fp32 in JAX's promotion, which the port mirrors (torch would
treat the 0-d gate as a scalar and stay in bf16).

Parameters are drawn by numpy into JAX's tree (``torch_encdec_parity``:
the gates N(0, 0.5^2), where the reference's zeros would make the block an
identity) and carried over by ``convert``. The bars: the blocks at rtol
1e-5 of max |out| (fp32); the bf16 ``cross`` block's fp32 output at the
model's bf16 bar, max |d| <= 4e-3 max |out| (``test_torch_layers.py``'s:
the two packages' bf16 products round their fp32 sums apart now and
then; measured 1.1e-3); the logits at ``P.TOL``, the losses at rtol 1e-5
and every gradient at rtol 1e-4 of the leaf's max |grad| (the bars of
``test_torch_model_train.py``); prefill + decode: the logits against the
forward and JAX's at ``P.TOL``, the cache entries at rtol 1e-4 of their
max |entry| (five fp32 layers deep; measured 1.5e-5 absolute on an entry
of 0.027); greedy streams token for token; a 5-step DCT-AdamW trajectory
of the pattern ``("attn", "cross")`` once (the cross block trains, as one
does on the card) at ``R.TRAJECTORY_RTOL`` (measured <= 6.6e-5 over three
draws). The five-layer smoke model's trajectory parts by 1.6e-4 / 7.1e-4
at steps 4 / 5 (up to 1.5e-3 over other draws): as at jamba's and rwkv6's
deep configs (``torch_recurrent_parity.deep_routing``), random layers'
fp32 gradient differences are carried by Adam's sign-like first steps and
the top-r reselection into the later losses; it also costs three times
the compile.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse
import torch_dense_parity as P
import torch_encdec_parity as E
import torch_recurrent_parity as R

from repro.configs import llama32_vision_90b as jax_vision
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine
from repro_torch.train import steps as TS

ARCH = "llama-3.2-vision-90b"
JCFG = jax_vision.SMOKE
CFG = get_config(ARCH, smoke=True)
#: the real config's precision at the smoke size
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
#: the prompt of the forward, prefill and decode comparisons
SEQ = 20
BLOCK_RTOL = 1e-5
#: the bf16 model's bar (``test_torch_layers.py``)
BF16_REL = 4e-3


@pytest.fixture(scope="module")
def model():
    """(jax params, port params) of the smoke config."""
    return E.pair(JCFG, seed=4)


@pytest.fixture(scope="module")
def jfn():
    """JAX's functions of the smoke model, jitted once for the module."""
    return {
        "forward": jax.jit(lambda p, b: JT.forward(p, b, JCFG)),
        "grad": jax.jit(lambda p, b: jax.value_and_grad(
            JS.loss_fn, has_aux=True)(p, b, JCFG)),
        "prefill": jax.jit(lambda p, b: JT.prefill(
            p, b, JCFG, max_len=SEQ + 4)[:2]),
        "decode": jax.jit(lambda p, c, tok, pos: JT.decode_step(
            p, c, tok, pos, JCFG)),
    }


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def _bf16_bar(got, want):
    want = np.asarray(want, np.float32)
    d = np.abs(got.detach().float().numpy() - want)
    assert d.max() <= BF16_REL * np.abs(want).max()


def test_configs_match_jax():
    P.configs_match(ARCH, jax_vision)
    assert CFG.family == "vlm" and CFG.block_kinds() == ("attn", "cross")
    assert CFG.schedule == ((("attn",) * 4 + ("cross",), 1),)
    assert CFG.n_image_tokens == 8 and CFG.attn_sp
    full = get_config(ARCH)
    assert (full.n_layers, full.n_image_tokens, full.kv_chunk) == \
        (100, 6400, 1024)
    assert (full.param_dtype, full.compute_dtype) == ("bfloat16", "bfloat16")


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_vision)
    assert 87.6e9 < n < 87.7e9


def test_full_config_labels_match_jax():
    """``default_label_fn`` over the full config's leaves equals JAX's: the
    cross layers' stacked (20, 8192, 1024) keys and their MLP are
    matrices, the gates (20,) full-rank."""
    labels = R.labels_match(ARCH, jax_vision)
    for leaf in ("p4/xattn/wk/kernel", "p4/xattn/wo/kernel",
                 "p4/mlp/wg/kernel", "p0/attn/wq/kernel"):
        assert labels[f"segments/0/{leaf}"] == "lowrank", leaf
    for leaf in ("p4/gate_attn", "p4/gate_mlp", "p4/ln1/scale"):
        assert labels[f"segments/0/{leaf}"] == "full", leaf


def test_init_params_match_jax_leaves(model):
    P.smoke_leaves_match(model[0], CFG)
    own = TT.init_params(CFG, seed=0, device="cpu")
    assert own["segments/0/p4/gate_attn"].shape == (1,)
    assert own["segments/0/p4/gate_attn"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["attn", "cross"])
def test_block_apply_matches_jax(model, kind):
    """An ``attn`` layer (p0) and the ``cross`` layer (p4) through
    ``block_apply`` on the same x and image embeddings: the output and the
    cache entry (the cross-attention's (xk, xv) of the image tokens, no
    rope)."""
    j = 0 if kind == "attn" else 4
    jlayer = E.layer(model[0], j)
    tlayer = convert.params_from_jax(jax.tree.map(np.asarray, jlayer),
                                     device="cpu")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, SEQ, 128)).astype(np.float32)
    img = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jx, _, jkv = jax.jit(lambda p, x, img: JT.block_apply(
        kind, p, x, JCFG, {"image_embeds": img}, return_kv=True))(
            jlayer, jnp.asarray(x), jnp.asarray(img))
    tx, _, tkv = TT.block_apply(kind, tlayer, torch.from_numpy(x), CFG,
                                {"image_embeds": torch.from_numpy(img)},
                                return_kv=True)
    _close(tx, jx, BLOCK_RTOL)
    for got, want in zip(tkv, jkv):
        _close(got, want, BLOCK_RTOL)
    if kind == "cross":
        assert tkv[0].shape == (2, 8, 2, 32)


def test_bf16_cross_block_promotes_to_fp32_like_jax():
    """With bf16 parameters and compute the ``cross`` block's output is
    fp32 in both packages (the fp32 gates), through ``block_apply`` and
    ``block_decode``, at the bf16 bar of JAX's; the ``attn`` block's stays
    bf16."""
    jcfg = dataclasses.replace(JCFG, **BF16)
    tcfg = dataclasses.replace(CFG, **BF16)
    jp, _ = E.pair(jcfg, seed=5)
    jlayer = JT.cast_params(E.layer(jp, 4), jcfg)
    tlayer = convert.params_from_jax(jax.tree.map(np.asarray, jlayer),
                                     device="cpu")
    assert tlayer["xattn/wq/kernel"].dtype == torch.bfloat16
    assert tlayer["gate_attn"].dtype == torch.float32
    rng = np.random.default_rng(13)
    x, img = (rng.standard_normal(s).astype(np.float32)
              for s in ((2, SEQ, 128), (2, 8, 128)))
    jx16, jimg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16)
    tx16 = torch.from_numpy(x).bfloat16()
    timg = torch.from_numpy(img).bfloat16()
    jx, _, (jxk, jxv) = jax.jit(lambda p, x, img: JT.block_apply(
        "cross", p, x, jcfg, {"image_embeds": img}, return_kv=True))(
            jlayer, jx16, jimg)
    tx, _, (txk, txv) = TT.block_apply("cross", tlayer, tx16, tcfg,
                                       {"image_embeds": timg}, return_kv=True)
    assert str(jx.dtype) == "float32" and tx.dtype == torch.float32
    _bf16_bar(tx, jx)
    cache = {"xk": txk.bfloat16(), "xv": txv.bfloat16()}
    jout, _ = jax.jit(lambda p, x, c: JT.block_decode(
        "cross", p, x, c, jnp.zeros((2,), jnp.int32), jcfg))(
            jlayer, jx16[:, 0], {"xk": jxk.astype(jnp.bfloat16),
                                 "xv": jxv.astype(jnp.bfloat16)})
    tout, _ = TT.block_decode("cross", tlayer, tx16[:, 0], cache,
                              torch.zeros(2, dtype=torch.long), tcfg)
    assert str(jout.dtype) == "float32" and tout.dtype == torch.float32
    _bf16_bar(tout, jout)
    attn = convert.params_from_jax(jax.tree.map(
        np.asarray, JT.cast_params(E.layer(jp, 0), jcfg)), device="cpu")
    assert TT.block_apply("attn", attn, tx16, tcfg)[0].dtype == torch.bfloat16


def test_logits_loss_grads_match_jax(model, jfn):
    """Logits, the loss and the gradient of every leaf (the gates and the
    cross-attention's included) with the image embeddings."""
    jp, tp = model
    b = E.batch(JCFG, 0, SEQ + 1)
    toks = b.pop("tokens")
    b.update(tokens=toks[:, :-1], targets=toks[:, 1:])
    inputs = {k: v for k, v in b.items() if k != "targets"}
    jl, _ = jfn["forward"](jp, E.to_jax(inputs))
    tl, _ = TT.forward(tp, E.to_torch(inputs), CFG)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **P.TOL)
    (_, jm), jg = jfn["grad"](jp, E.to_jax(b))
    tg, tm = TS.grad_fn(tp, E.to_torch(b), CFG)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg),
                                   device="cpu")
    assert set(tg) == set(want)
    assert tg["segments/0/p4/gate_attn"].abs().item() > 0
    for path, g in tg.items():
        _close(g, want[path], 1e-4, path)


def test_prefill_route_sends_each_attention_layer_to_a_kernel(model,
                                                              monkeypatch):
    """A bf16 prefill with the route's device test saying "card" and spies
    in place of the launchers: 5 calls of the blockwise kernel, 4 causal
    self-attentions (SEQ keys) and the cross-attention (8 image tokens, no
    mask), each with the model's kv_chunk (the wrapper resolves it against
    the keys' length) and q_offset 0; the last logits equal the plain
    route's."""
    cfg = dataclasses.replace(CFG, **BF16)
    _, tp = model
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    blockwise = TL.flash_attention_blockwise

    def spy(q, k, v, **kw):
        calls.append((q.dtype, q.shape[1], k.shape[1], kw))
        return blockwise(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention_blockwise", spy)
    monkeypatch.setattr(TL, "flash_attention_op", None)
    b = E.to_torch(E.batch(JCFG, 2, SEQ))
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, b, cfg, max_len=SEQ)
    self_kw = dict(causal=True, window=None, kv_chunk=cfg.kv_chunk,
                   q_offset=0)
    cross_kw = dict(causal=False, window=None, kv_chunk=cfg.kv_chunk,
                    q_offset=0)
    assert calls == [(torch.bfloat16, SEQ, SEQ, self_kw)] * 4 + \
        [(torch.bfloat16, SEQ, 8, cross_kw)]
    assert cache["segments/0/p4/xk"].shape == (1, 2, 8, 2, 32)
    monkeypatch.setattr(TL, "_on_card", lambda t: False)
    with torch.inference_mode():
        plain, _, _ = TT.prefill(tp, b, cfg, max_len=SEQ)
    assert torch.equal(last, plain)


def test_prefill_decode_matches_forward_and_jax(model, jfn):
    """``prefill`` of SEQ - 4 tokens with the image embeddings and 4
    ``decode_step``s equal the forward's logits at those positions, and
    JAX's prefill and decode (logits and every cache entry: the ``attn``
    layers' k / v, the ``cross`` layer's xk / xv)."""
    jp, tp = model
    b = E.batch(JCFG, 1, SEQ)
    full, _ = TT.forward(tp, E.to_torch(b), CFG)
    n = SEQ - 4
    pb = {**b, "tokens": b["tokens"][:, :n]}
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, E.to_torch(pb), CFG, max_len=SEQ + 4)
    jlast, jcache = jfn["prefill"](jp, E.to_jax(pb))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in TT.init_cache(
            CFG, 2, SEQ + 4, device="cpu").items()}
    assert set(cache) == {f"segments/0/p{j}/{n}" for j in range(4)
                          for n in "kv"} | {"segments/0/p4/xk",
                                            "segments/0/p4/xv"}
    toks = b["tokens"]
    steps = [(last, jlast)]
    for i in range(n, SEQ):
        for key, want in convert.pools_from_jax(
                jax.tree.map(np.asarray, jcache), device="cpu").items():
            _close(cache[key], want.numpy(), 1e-4, key)
        with torch.inference_mode():
            lg, cache = TT.decode_step(tp, cache, torch.from_numpy(
                toks[:, i]), i, CFG)
        jlg, jcache = jfn["decode"](jp, jcache, jnp.asarray(
            toks[:, i], jnp.int32), jnp.int32(i))
        steps.append((lg, jlg))
    for j, (got, want) in enumerate(steps):
        pos = n - 1 + j
        np.testing.assert_allclose(got.numpy(), full[:, pos].detach().numpy(),
                                   **P.TOL, err_msg=f"position {pos}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **P.TOL,
                                   err_msg=f"position {pos}")


def test_generate_matches_stepwise_forward_oracle(model, jfn):
    E.oracle_stream(*model, JCFG, CFG, lambda p, b: jfn["forward"](p, b)[0])


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
    """The pattern ``("attn", "cross")`` once (module docstring)."""
    sched = ((("attn", "cross"), 1),)
    jcfg = dataclasses.replace(JCFG, schedule=sched)
    tcfg = dataclasses.replace(CFG, schedule=sched)
    tl, jl = R.trajectory(jcfg, tcfg, *E.pair(jcfg, seed=4),
                          batches=E.train_batches(jcfg, 5))
    np.testing.assert_allclose(tl, jl, rtol=R.TRAJECTORY_RTOL)
    assert tl[-1] < tl[0]


def test_synthetic_batches_carry_image_embeddings():
    """``make_batch_fn`` adds ``image_embeds`` (B, n_image_tokens, d) in
    the compute dtype, deterministic in (seed, step)."""
    fn = make_batch_fn(CFG, 8, 2, seed=1, device="cpu")
    b0, b1 = fn(0), fn(1)
    assert set(b0) == {"tokens", "targets", "image_embeds"}
    assert b0["image_embeds"].shape == (2, 8, 128)
    assert b0["image_embeds"].dtype == torch.float32
    assert torch.equal(b0["image_embeds"], fn(0)["image_embeds"])
    assert not torch.equal(b0["image_embeds"], b1["image_embeds"])


@pytest.mark.parametrize("engine", ["dense", "train"])
def test_clis_run_on_cpu(engine):
    P.cli_runs(ARCH, engine)
