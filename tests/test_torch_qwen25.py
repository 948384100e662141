"""qwen2.5-32b in the port against the JAX package: qkv bias, group 5,
``attn_sp``, rope theta 1e6, bf16 parameters.

Smoke sizes and shared checks: ``torch_dense_parity.py``. The parameters
and biases are drawn by numpy (biases N(0, 0.5)); every comparison runs to
position 79. Measured tolerances of the bf16 cases (this file's own cases
on the CPU):

* bf16 parameters and compute (group 5): both packages round every
  product, norm and activation to bf16 but in other orders and with other
  elementwise kernels (28% of the logits bit-equal; ~24% for the llamas,
  with or without a bias), max |d| 7.2e-3 of max |logit| (under one bf16
  ulp at the top): held at ``BF16_REL``.
* fp32 parameters with bf16 compute (group 5): the fp32 bias widens q, k
  and v to fp32 in both (the fp32 attention route), 99.95% bit-equal, max
  |d| 1.8e-3 of max |logit|: held at ``MIXED_REL``.
* one DCT-AdamW step on bf16 parameters (bf16 gradients, the update in
  fp32, cast to bf16 and added in bf16, as the reference's
  ``apply_updates`` does): loss equal (held at rtol 1e-5); per leaf
  >= 99.991% of the elements within one bf16 ulp of their magnitude (held
  at ``STEP_BF16_SHARE``), every element within 0.098 lr (held at
  ``STEP_BF16_LR``): a gradient's last bf16 rounding moves a projected
  entry near zero, and Adam's first step normalises it to +-lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dense_parity as P

from repro.configs import qwen25_32b as jax_qwen
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.optim.common import default_label_fn as jax_label_fn
from repro.train import steps as JS
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT
from repro_torch.optim.api import get_optimizer
from repro_torch.optim.common import default_label_fn
from repro_torch.train import steps as TS

ARCH = "qwen2.5-32b"
JCFG = jax_qwen.SMOKE
CFG = get_config(ARCH, smoke=True)
# the real GQA geometry: 10 q heads over 2 kv heads (group 5)
FAITHFUL = dict(n_heads=10, n_kv_heads=2)
BF16_REL = 1.5e-2
MIXED_REL = 8e-3
STEP_BF16_SHARE = 0.999
STEP_BF16_LR = 0.25
LR = 0.01
ILL_CONDITIONED_G = 1e-6


@pytest.fixture(scope="module")
def smoke():
    return P.pair(JCFG)


@pytest.fixture(scope="module")
def faithful():
    jcfg = jax_qwen.CONFIG.reduced(**FAITHFUL)
    tcfg = get_config(ARCH).reduced(**FAITHFUL)
    return (jcfg, tcfg, *P.pair(jcfg))


def test_configs_match_jax():
    P.configs_match(ARCH, jax_qwen)
    assert CFG.qkv_bias and CFG.attn_sp and CFG.rope_theta == 1e6


def test_registry_leaves_six_archs_unported():
    """Every architecture of the JAX registry is ported: ``list_archs()``
    equals JAX's and ``NOT_YET_PORTED`` is empty."""
    from repro.configs import registry as jax_registry
    assert registry.NOT_YET_PORTED == ()
    assert registry.list_archs() == jax_registry.list_archs()
    for arch in registry.list_archs():
        assert get_config(arch).name == jax_registry.get_config(arch).name


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_qwen)
    assert 32e9 < n < 34e9


def test_init_params_and_convert_carry_the_biases(smoke):
    jparams, tparams = smoke
    P.smoke_leaves_match(jparams, CFG)
    pre = "segments/0/p0/attn/"
    hd = CFG.hd
    assert tparams[pre + "wq/bias"].shape == (1, CFG.n_heads * hd)
    assert tparams[pre + "wk/bias"].shape == (1, CFG.n_kv_heads * hd)
    for n in "qkv":
        want = np.asarray(jparams["segments"][0]["p0"]["attn"][f"w{n}"]["bias"])
        assert np.array_equal(tparams[pre + f"w{n}/bias"].numpy(), want)
        assert np.abs(want).max() > 0.1
    own = TT.init_params(CFG, seed=0, device="cpu")
    assert all(torch.count_nonzero(own[pre + f"w{n}/bias"]) == 0
               for n in "qkv")


def test_biases_are_labelled_full(smoke):
    _, tparams = smoke
    for path in ("segments/0/p0/attn/wq/bias", "segments/0/p0/attn/wv/bias"):
        leaf = tparams[path]
        assert leaf.ndim == 2
        assert default_label_fn(path, leaf) == "full" \
            == jax_label_fn(path, leaf.numpy())
    assert default_label_fn("segments/0/p0/attn/wq/kernel",
                            tparams["segments/0/p0/attn/wq/kernel"]) \
        == "lowrank"


@pytest.mark.parametrize("geometry", ["smoke", "group 5"])
def test_forward_logits_match_jax(smoke, faithful, geometry):
    if geometry == "smoke":
        jcfg, tcfg, (jp, tp) = JCFG, CFG, smoke
    else:
        jcfg, tcfg, jp, tp = faithful
    want, got = P.logits(jp, tp, jcfg, tcfg)
    np.testing.assert_allclose(got, want, **P.TOL)


@pytest.mark.parametrize("dtypes,rel", [
    (dict(param_dtype="bfloat16", compute_dtype="bfloat16"), BF16_REL),
    (dict(compute_dtype="bfloat16"), MIXED_REL)])
def test_bf16_forward_logits_match_jax(dtypes, rel):
    jcfg = jax_qwen.CONFIG.reduced(**FAITHFUL, **dtypes)
    tcfg = get_config(ARCH).reduced(**FAITHFUL, **dtypes)
    jp, tp = P.pair(jcfg)
    assert tp["segments/0/p0/attn/wq/bias"].dtype == \
        getattr(torch, jcfg.param_dtype)
    want, got = P.logits(jp, tp, jcfg, tcfg)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_dense_engine_greedy_stream_matches_jax(faithful):
    P.dense_stream(*faithful[2:], *faithful[:2])


def test_paged_engine_greedy_streams_match_jax(faithful):
    P.paged_streams(*faithful[2:], *faithful[:2])


def test_paged_decode_and_prefill_chunks_match_jax(faithful):
    P.paged_chunks_and_decode(*faithful[2:], *faithful[:2])


def _step_batch(vocab, b=2, s=P.SEQ):
    toks = np.random.default_rng(5).integers(2, vocab, (b, s + 1)
                                             ).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_dct_adamw_step_matches_jax(smoke, param_dtype):
    """One DCT-AdamW step (rank 16: a top-16 selection on every matrix
    leaf): the port on its kernel path (``fused="on"``: the kernels' plain
    versions on the CPU) against the JAX reference path. Adam's first step
    is ``lr * g / (|g| + eps)``: where |g| is within a few orders of eps
    (1e-8; a token's embedding row, the key bias, whose gradient only the
    rope's rotation keeps from vanishing) an fp32 difference in g moves it
    by up to 2 lr. Such elements (|g| < ``ILL_CONDITIONED_G``) are held
    within 2 lr, the rest at the stated tolerance."""
    jcfg = dataclasses.replace(JCFG, param_dtype=param_dtype)
    tcfg = dataclasses.replace(CFG, param_dtype=param_dtype)
    # the smoke config's own dtype: the module's parameters, drawn once
    jparams, tparams = smoke if jcfg == JCFG else P.pair(jcfg)
    jopt = jax_get_optimizer("dct_adamw", lr=LR, rank=16, fused="off")
    topt = get_optimizer("dct_adamw", lr=LR, rank=16, fused="on")
    batch = _step_batch(jcfg.vocab_size)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstate, jm = jax.jit(JS.make_train_step(jcfg, jopt))(
        JS.TrainState(jnp.zeros((), jnp.int32), jparams, jopt.init(jparams)),
        jax.tree.map(jnp.asarray, batch))
    tstate, tm = TS.make_train_step(tcfg, topt)(
        TS.TrainState(0, tparams, topt.init(tparams)), tbatch)
    grads, _ = TS.grad_fn(tparams, tbatch, tcfg)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   device="cpu")
    bf16 = param_dtype == "bfloat16"
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert set(tstate.params) == set(want)
    for path, p in tstate.params.items():
        assert p.dtype == want[path].dtype, path
        got, ref = p.float().numpy(), want[path].float().numpy()
        tiny = np.abs(grads[path].float().numpy()) < ILL_CONDITIONED_G
        assert (np.abs(got - ref)[tiny] <= 2 * LR + 1e-7).all(), path
        got, ref = got[~tiny], ref[~tiny]
        if bf16:
            # one bf16 ulp (2^-7 relative) of each element's magnitude
            d = np.abs(got - ref)
            ulp = np.maximum(np.abs(ref), np.abs(got)) * 2.0 ** -7
            assert (d <= ulp).mean() >= STEP_BF16_SHARE, path
            assert (d <= STEP_BF16_LR * LR).all(), path
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=path)
    for n in "qkv":
        bias = f"segments/0/p0/attn/w{n}/bias"
        assert not torch.equal(tstate.params[bias], tparams[bias])


@pytest.mark.parametrize("engine", ["dense", "paged", "train"])
def test_cli_runs_on_cpu(engine):
    P.cli_runs(ARCH, engine)
