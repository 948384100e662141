"""command-r-plus-104b in the port against the JAX package: 96 q heads over
8 kv heads (group 12), ``attn_sp``, rope theta 7.5e7, bf16 parameters.

Smoke sizes and shared checks: ``torch_dense_parity.py``; the shape-faithful
smoke keeps group 12 (12 q heads over one kv head of 32). Every comparison
runs to position 79. The full configuration's dtypes (bf16 parameters and
compute) are held at ``BF16_REL`` of max |logit|: both packages round each
product and activation to bf16 in other orders (measured 9.0e-3, about one
bf16 ulp at the top, 24.6% of the logits bit-equal; this file's case on
the CPU).
"""
import numpy as np
import pytest
import torch_dense_parity as P

from repro.configs import command_r_plus_104b as jax_cr
from repro_torch.configs.registry import get_config

ARCH = "command-r-plus-104b"
JCFG = jax_cr.SMOKE
CFG = get_config(ARCH, smoke=True)
FAITHFUL = dict(n_heads=12, n_kv_heads=1)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BF16_REL = 1.5e-2


@pytest.fixture(scope="module")
def smoke():
    return P.pair(JCFG)


@pytest.fixture(scope="module")
def faithful():
    jcfg = jax_cr.CONFIG.reduced(**FAITHFUL)
    tcfg = get_config(ARCH).reduced(**FAITHFUL)
    return (jcfg, tcfg, *P.pair(jcfg))


def test_configs_match_jax():
    P.configs_match(ARCH, jax_cr)
    cfg = get_config(ARCH)
    assert cfg.n_heads // cfg.n_kv_heads == 12 and cfg.attn_sp \
        and cfg.rope_theta == 7.5e7 and not cfg.tie_embeddings


def test_full_config_on_meta_matches_jax_eval_shape():
    n = P.full_config_matches_eval_shape(ARCH, jax_cr)
    assert 1.06e11 < n < 1.08e11


def test_init_params_match_jax_leaves(smoke):
    P.smoke_leaves_match(smoke[0], CFG)


@pytest.mark.parametrize("geometry", ["smoke", "group 12", "group 12 bf16"])
def test_forward_logits_match_jax(smoke, faithful, geometry):
    if geometry == "smoke":
        jcfg, tcfg, (jp, tp) = JCFG, CFG, smoke
    elif geometry == "group 12":
        jcfg, tcfg, jp, tp = faithful
    else:
        jcfg = jax_cr.CONFIG.reduced(**FAITHFUL, **BF16)
        tcfg = get_config(ARCH).reduced(**FAITHFUL, **BF16)
        jp, tp = P.pair(jcfg)
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
