"""whisper-large-v3, the encoder-decoder family, in the port against the
JAX package at its smoke config (d=128, 2 ``enc`` and 2 ``dec`` layers, 4
heads of 32, 16 stub frames, fp32), and with bf16 compute beside fp32
parameters, the real config's precision: its fp32 biases widen the
attention and the MLPs to fp32, in JAX's promotion and in the port's.

Parameters are drawn by numpy into JAX's tree (``torch_encdec_parity``)
and carried over by ``convert``. The bars: ``gelu_mlp``, ``encode`` and
the blocks at rtol 1e-5 of max |out| (fp32); the logits at ``P.TOL``, the
losses at rtol 1e-5 and every gradient at rtol 1e-4 of the leaf's max
|grad| (the bars of ``test_torch_model_train.py``; the key biases of the
attentions without rope, the encoder's and the cross-attentions', have a
gradient of zero in exact arithmetic, a softmax being blind to a shift of
every score of a row, and are held to that); with bf16 compute the encoder's
output and the logits within ``BF16_REL`` of their max |out| and every
position's top-1 equal (measured over 9 draws: one bf16 ulp of the
largest logit, 4.8e-3 to 5.3e-3, 54-84% of the logits bit-equal: the two
packages' bf16 products round their fp32 sums apart now and then);
prefill + decode against the forward and JAX's at ``P.TOL``; greedy
streams token for token; 5-step DCT-AdamW trajectories at
``R.TRAJECTORY_RTOL`` in fp32 and at ``BF16_TRAJECTORY_RTOL`` with bf16
compute (measured 2.6e-4: those roundings, carried by Adam's sign-like
first steps).
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

from repro.configs import whisper_large_v3 as jax_whisper
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import SyntheticLM, make_batch_fn
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine
from repro_torch.train import steps as TS

ARCH = "whisper-large-v3"
JCFG = jax_whisper.SMOKE
CFG = get_config(ARCH, smoke=True)
#: the real config's precision at the smoke size
JCFG16 = dataclasses.replace(JCFG, compute_dtype="bfloat16")
CFG16 = dataclasses.replace(CFG, compute_dtype="bfloat16")
#: the prompt of the forward, prefill and decode comparisons
SEQ = 20
BLOCK_RTOL = 1e-5
#: bf16 compute: max |d| / max |out| (two bf16 ulps of the largest)
BF16_REL = 1e-2
#: bf16 compute: the losses of the 5-step trajectories
BF16_TRAJECTORY_RTOL = 1e-3


@pytest.fixture(scope="module")
def model():
    """(jax params, port params) of the smoke config (fp32 parameters,
    which the bf16-compute config shares)."""
    return E.pair(JCFG, seed=3)


@pytest.fixture(scope="module")
def jfn():
    """JAX's functions of the smoke model, jitted once for the module."""
    return {
        "forward": jax.jit(lambda p, b: JT.forward(p, b, JCFG)),
        "forward16": jax.jit(lambda p, b: JT.forward(p, b, JCFG16)),
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


def test_configs_match_jax():
    P.configs_match(ARCH, jax_whisper)
    assert CFG.family == "encdec" and CFG.block_kinds() == ("dec",)
    assert (CFG.encoder_layers, CFG.encoder_seq, CFG.n_layers) == (2, 16, 2)
    full = get_config(ARCH)
    assert (full.encoder_layers, full.encoder_seq, full.n_layers) == \
        (32, 1500, 32)
    assert (full.param_dtype, full.compute_dtype) == ("float32", "bfloat16")


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_whisper)
    assert 1.60e9 < n < 1.61e9


def test_full_config_labels_match_jax():
    """``default_label_fn`` over the full config's leaves equals JAX's: the
    encoder's and the decoder's stacked (32, 1280, 1280) projections and
    (32, 1280, 5120) MLPs are matrices; the biases, the layer norms and the
    embedding stay full-rank."""
    labels = R.labels_match(ARCH, jax_whisper)
    for leaf in ("encoder/blocks/attn/wq/kernel", "encoder/blocks/mlp/wi/kernel",
                 "segments/0/p0/xattn/wk/kernel",
                 "segments/0/p0/mlp/wo/kernel"):
        assert labels[leaf] == "lowrank", leaf
    for leaf in ("encoder/blocks/attn/wq/bias", "encoder/ln_post/scale",
                 "segments/0/p0/ln3/bias", "segments/0/p0/xattn/wo/bias",
                 "final_norm/bias", "embed/kernel"):
        assert labels[leaf] == "full", leaf


def test_init_params_match_jax_leaves(model):
    P.smoke_leaves_match(model[0], CFG)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(weights):
    """``gelu(x @ wi + bi) @ wo + bo`` (tanh GELU); with bf16 activations
    and weights beside fp32 biases the result is fp32 in both packages."""
    rng = np.random.default_rng(0)
    x, wi, bi, wo, bo = (rng.standard_normal(s).astype(np.float32) * 0.3
                         for s in ((2, 5, 64), (64, 96), (96,), (96, 64),
                                   (64,)))
    jdt, tdt = getattr(jnp, weights), getattr(torch, weights)
    want = JL.gelu_mlp(jnp.asarray(x, jdt), jnp.asarray(wi, jdt),
                       jnp.asarray(bi), jnp.asarray(wo, jdt), jnp.asarray(bo))
    got = TL.gelu_mlp(torch.from_numpy(x).to(tdt), torch.from_numpy(wi).to(tdt),
                      torch.from_numpy(bi), torch.from_numpy(wo).to(tdt),
                      torch.from_numpy(bo))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-6 if weights == "float32" else 1e-5)


@pytest.mark.parametrize("cfgs", ["fp32", "bf16 compute"])
def test_encode_matches_jax(model, cfgs):
    """The sinusoid and the encoder (2 ``enc`` layers and ``ln_post``) on
    the cast parameters, against JAX's; with bf16 compute its output is
    bf16, its attention fp32 (the fp32 biases)."""
    jcfg, tcfg = (JCFG, CFG) if cfgs == "fp32" else (JCFG16, CFG16)
    jp, tp = model
    frames = E.stubs(JCFG, 2, 7)["frames"]
    want = jax.jit(lambda p, f: JT.encode(JT.cast_params(p, jcfg), f, jcfg))(
        jp, jnp.asarray(frames))
    got = TT.encode(TT.cast_params(tp, tcfg), torch.from_numpy(frames), tcfg)
    assert got.dtype == getattr(torch, tcfg.compute_dtype)
    assert str(want.dtype) == tcfg.compute_dtype
    sin = TT._sinusoid(16, 128, torch.float32, "cpu")
    _close(sin, JT._sinusoid(16, 128, jnp.float32), 1e-6)
    if cfgs == "fp32":
        _close(got, want, BLOCK_RTOL)
    else:
        d = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert d.max() <= BF16_REL * np.abs(np.asarray(want, np.float32)).max()


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_apply_matches_jax(model, kind):
    """One ``enc`` / ``dec`` layer (layer 1 of its stack) through
    ``block_apply`` on the same x and encoder output: the block's output
    and, for ``dec``, its cache entry ((k, v) roped, (xk, xv) of the
    frames)."""
    jp, _ = model
    jlayer = (jax.tree.map(lambda a: a[1], jp["encoder"]["blocks"])
              if kind == "enc" else E.layer(jp, 0, 1))
    tlayer = convert.params_from_jax(jax.tree.map(np.asarray, jlayer),
                                     device="cpu")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, SEQ, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 16, 128)).astype(np.float32)
    jx, _, jkv = jax.jit(lambda p, x, enc: JT.block_apply(
        kind, p, x, JCFG, {"enc_out": enc}, return_kv=True))(
            jlayer, jnp.asarray(x), jnp.asarray(enc))
    tx, aux, tkv = TT.block_apply(kind, tlayer, torch.from_numpy(x), CFG,
                                  {"enc_out": torch.from_numpy(enc)},
                                  return_kv=True)
    _close(tx, jx, BLOCK_RTOL)
    assert float(aux) == 0.0
    if kind == "enc":
        assert tkv is None and jkv is None
        return
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        _close(tk, jk, BLOCK_RTOL)
        _close(tv, jv, BLOCK_RTOL)
    assert tkv[1][0].shape == (2, 16, 4, 32)


def test_logits_loss_grads_match_jax(model, jfn):
    """Logits, the loss and the gradient of every leaf (the encoder's
    included) with the frames."""
    jp, tp = model
    b = E.batch(JCFG, 0, SEQ + 1)
    toks = b.pop("tokens")
    b.update(tokens=toks[:, :-1], targets=toks[:, 1:])
    inputs = {k: v for k, v in b.items() if k != "targets"}
    jl, _ = jfn["forward"](jp, E.to_jax(inputs))
    tl, taux = TT.forward(tp, E.to_torch(inputs), CFG)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **P.TOL)
    assert float(taux["moe_aux"]) == 0.0
    (_, jm), jg = jfn["grad"](jp, E.to_jax(b))
    tg, tm = TS.grad_fn(tp, E.to_torch(b), CFG)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg),
                                   device="cpu")
    assert set(tg) == set(want)
    top = max(g.abs().max().item() for g in tg.values())
    for path, g in tg.items():
        if path.endswith(("encoder/blocks/attn/wk/bias", "xattn/wk/bias")):
            assert g.abs().max().item() <= 1e-6 * top, path
            assert want[path].abs().max().item() <= 1e-6 * top, path
        else:
            _close(g, want[path], 1e-4, path)


def test_bf16_compute_runs_attention_in_fp32_like_jax(model, jfn,
                                                      monkeypatch):
    """With bf16 compute beside fp32 parameters the logits are bf16, JAX's
    too, and within the bf16 bar of JAX's (every top-1 equal); every
    attention call (2
    encoder, 2 decoder self-, 2 cross-attention) gets fp32 q, k and v: the
    fp32 biases widen them, so on the card the prefill's route is the fp32
    ``flash_attention``."""
    jp, tp = model
    b = E.batch(JCFG, 1, SEQ)
    want = np.asarray(jfn["forward16"](jp, E.to_jax(b))[0])
    assert str(jfn["forward16"](jp, E.to_jax(b))[0].dtype) == "bfloat16"
    calls = []
    route = TT.blockwise_attention

    def spy(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype, q.shape[1], k.shape[1],
                      kw["causal"]))
        return route(q, k, v, **kw)

    monkeypatch.setattr(TT, "blockwise_attention", spy)
    got, _ = TT.forward(tp, E.to_torch(b), CFG16)
    assert got.dtype == torch.bfloat16
    f32 = (torch.float32,) * 3
    assert calls == [(*f32, 16, 16, False)] * 2 + \
        [(*f32, SEQ, SEQ, True), (*f32, SEQ, 16, False)] * 2
    got = got.float().detach().numpy()
    want = want.astype(np.float32)
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_prefill_route_sends_every_attention_to_the_fp32_kernel(
        model, monkeypatch):
    """A bf16-compute prefill with the route's device test saying "card"
    and spies in place of the launchers: all 6 attention calls go to the
    fp32 ``flash_attention`` (the cross-attentions with 16 keys beside SEQ
    queries), none to the blockwise kernel, and the last logits equal the
    plain route's within the bf16 bar."""
    _, tp = model
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)

    def spy(name, fn):
        def call(q, k, v, **kw):
            calls.append((name, q.dtype, q.shape[1], k.shape[1]))
            return fn(q, k, v, **kw)
        return call

    fa = TL.flash_attention_op
    monkeypatch.setattr(TL, "flash_attention_op", spy("flash", fa))
    monkeypatch.setattr(TL, "flash_attention_blockwise",
                        spy("blockwise", TL.flash_attention_blockwise))
    b = E.to_torch(E.batch(JCFG, 2, SEQ))
    with torch.inference_mode():
        last, _, _ = TT.prefill(tp, b, CFG16, max_len=SEQ)
    assert calls == [("flash", torch.float32, 16, 16)] * 2 + [
        ("flash", torch.float32, SEQ, SEQ),
        ("flash", torch.float32, SEQ, 16)] * 2
    monkeypatch.setattr(TL, "_on_card", lambda t: False)
    with torch.inference_mode():
        plain, _, _ = TT.prefill(tp, b, CFG16, max_len=SEQ)
    d = (last.float() - plain.float()).abs()
    assert d.max().item() <= BF16_REL * plain.float().abs().max().item()


def test_prefill_decode_matches_forward_and_jax(model, jfn):
    """``prefill`` of SEQ - 4 tokens with the frames and 4
    ``decode_step``s equal the forward's logits at those positions, and
    JAX's prefill and decode (logits and every cache entry: the self
    attention's k / v and the cross-attention's xk / xv)."""
    jp, tp = model
    b = E.batch(JCFG, 1, SEQ)
    full, _ = TT.forward(tp, E.to_torch(b), CFG)
    n = SEQ - 4
    pb = {**b, "tokens": b["tokens"][:, :n]}
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, E.to_torch(pb), CFG, max_len=SEQ + 4)
    jlast, jcache = jfn["prefill"](jp, E.to_jax(pb))
    assert set(cache) == {f"segments/0/p0/{n}" for n in ("k", "v", "xk", "xv")}
    assert tuple(cache["segments/0/p0/xk"].shape) == (2, 2, 16, 4, 32)
    assert tuple(cache["segments/0/p0/k"].shape) == (2, 2, SEQ + 4, 4, 32)
    init = TT.init_cache(CFG, 2, SEQ + 4, device="cpu")
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in cache.items()}
    toks = b["tokens"]
    steps = [(last, jlast)]
    for i in range(n, SEQ):
        for key, want in convert.pools_from_jax(
                jax.tree.map(np.asarray, jcache), device="cpu").items():
            np.testing.assert_allclose(cache[key].numpy(), want.numpy(),
                                       **P.TOL, err_msg=key)
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


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_five_step_dct_adamw_trajectory_matches_jax(model, compute):
    """5 DCT-AdamW steps of both packages from the same fp32 parameters on
    the same batches (with frames): in fp32, and with bf16 compute (fp32
    attention and MLPs, bf16 residual stream and logits)."""
    jcfg, tcfg = (JCFG, CFG) if compute == "float32" else (JCFG16, CFG16)
    tl, jl = R.trajectory(jcfg, tcfg, *model,
                          batches=E.train_batches(JCFG, 5))
    np.testing.assert_allclose(tl, jl, rtol=R.TRAJECTORY_RTOL
                               if compute == "float32"
                               else BF16_TRAJECTORY_RTOL)
    assert tl[-1] < tl[0]


def test_synthetic_batches_carry_frames():
    """``make_batch_fn`` adds ``frames`` (B, encoder_seq, d) in the compute
    dtype, 0.02 * N(0, 1), deterministic in (seed, step) and from another
    stream than the tokens, which stay ``SyntheticLM``'s."""
    fn = make_batch_fn(CFG16, 8, 3, seed=5, device="cpu")
    b0, again, b1 = fn(0), fn(0), fn(1)
    assert set(b0) == {"tokens", "targets", "frames"}
    assert b0["frames"].shape == (3, 16, 128)
    assert b0["frames"].dtype == torch.bfloat16
    assert torch.equal(b0["frames"], again["frames"])
    assert not torch.equal(b0["frames"], b1["frames"])
    assert 0.015 < b0["frames"].float().std().item() < 0.025
    want = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=8, global_batch=3,
                       seed=5).batch(0, "cpu")
    assert torch.equal(b0["tokens"], want["tokens"])


@pytest.mark.parametrize("engine", ["dense", "train"])
def test_clis_run_on_cpu(engine):
    P.cli_runs(ARCH, engine)
