"""phi3-mini-3.8b in the port against the JAX package: plain MHA (32 / 32
heads) of head dim 96, fp32 parameters.

Smoke sizes and shared checks: ``torch_dense_parity.py``; the shape-faithful
smoke keeps head dim 96 (4 heads of 96 over d=128). Every comparison runs
to position 79. The full configuration's compute dtype (bf16 over fp32
parameters) is held at ``BF16_REL`` of max |logit|: both packages round
each product and activation to bf16 in other orders (measured 7.5e-3,
under one bf16 ulp at the top, 24.5% of the logits bit-equal; this file's
case on the CPU).
"""
import numpy as np
import pytest
import torch_dense_parity as P

from repro.configs import phi3_mini_3p8b as jax_phi3
from repro_torch.configs.registry import get_config

ARCH = "phi3-mini-3.8b"
JCFG = jax_phi3.SMOKE
CFG = get_config(ARCH, smoke=True)
FAITHFUL = dict(head_dim=96)
BF16_REL = 1.5e-2


@pytest.fixture(scope="module")
def smoke():
    return P.pair(JCFG)


@pytest.fixture(scope="module")
def faithful():
    jcfg = jax_phi3.CONFIG.reduced(**FAITHFUL)
    tcfg = get_config(ARCH).reduced(**FAITHFUL)
    return (jcfg, tcfg, *P.pair(jcfg))


def test_configs_match_jax():
    P.configs_match(ARCH, jax_phi3)
    cfg = get_config(ARCH)
    assert cfg.hd == 96 and cfg.n_heads == cfg.n_kv_heads == 32 \
        and not cfg.qkv_bias and cfg.param_dtype == "float32"


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_phi3)
    assert 3.7e9 < n < 3.9e9


def test_init_params_match_jax_leaves(smoke):
    P.smoke_leaves_match(smoke[0], CFG)


@pytest.mark.parametrize("geometry", ["smoke", "hd 96", "hd 96 bf16"])
def test_forward_logits_match_jax(smoke, faithful, geometry):
    if geometry == "smoke":
        jcfg, tcfg, (jp, tp) = JCFG, CFG, smoke
    elif geometry == "hd 96":
        jcfg, tcfg, jp, tp = faithful
    else:
        jcfg = jax_phi3.CONFIG.reduced(**FAITHFUL, compute_dtype="bfloat16")
        tcfg = get_config(ARCH).reduced(**FAITHFUL, compute_dtype="bfloat16")
        jp, tp = faithful[2:]
    want, got = P.logits(jp, tp, jcfg, tcfg)
    if jcfg.compute_dtype == "bfloat16":
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **P.TOL)


def test_dense_engine_greedy_stream_matches_jax(faithful):
    P.dense_stream(*faithful[2:], *faithful[:2])


def test_paged_engine_greedy_streams_match_jax(faithful):
    P.paged_streams(*faithful[2:], *faithful[:2])


def test_paged_decode_and_prefill_chunks_match_jax(faithful):
    P.paged_chunks_and_decode(*faithful[2:], *faithful[:2])


@pytest.mark.parametrize("engine", ["dense", "paged", "train"])
def test_cli_runs_on_cpu(engine):
    P.cli_runs(ARCH, engine)
