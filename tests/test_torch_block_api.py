"""The per-block API of the port's model against the JAX package's:
``ATTN_KINDS``, ``init_block`` (its leaves' shapes and dtypes against
``jax.eval_shape`` of JAX's) and ``block_apply`` (one block on the same
numpy-drawn parameters, rtol 1e-5), the refusals of the kinds not ported
yet, and ``forward`` running every layer through ``block_apply``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT

CFG = get_config("llama-350m", smoke=True)


def _block_cfgs(arch):
    """The JAX and the port's smoke config of ``arch`` in fp32 (gemma3's:
    qk-norm, a sliding window of 8; qwen2.5's: the qkv bias; phi3's: head
    dim 96)."""
    from repro.configs.registry import get_config as jax_get_config
    over = dict(compute_dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _jax_block_shapes(kind, jcfg):
    tree = jax.eval_shape(lambda k: JT.init_block(k, kind, jcfg),
                          jax.random.PRNGKey(0))
    return {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,kind", [("gemma3-27b", "attn"),
                                       ("gemma3-27b", "local"),
                                       ("qwen2.5-32b", "attn"),
                                       ("phi3-mini-3.8b", "attn")])
def test_init_block_shapes_match_jax(arch, kind):
    jcfg, tcfg = _block_cfgs(arch)
    want = _jax_block_shapes(kind, jcfg)
    got = TT.init_block(torch.Generator().manual_seed(0), kind, tcfg)
    assert set(got) == set(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == leaf.dtype.name, k
        assert got[k].device.type == "cpu"
    meta = TT.init_block(None, kind, tcfg, "meta")
    assert {k: v.shape for k, v in meta.items()} == \
        {k: v.shape for k, v in got.items()}


@pytest.mark.parametrize("kind", ["attn", "local"])
@pytest.mark.parametrize("return_kv", [False, True])
def test_block_apply_matches_jax(kind, return_kv):
    """One gemma3 smoke block (qk-norm; ``local``: a window of 8 over 24
    positions) on parameters drawn by numpy into JAX's tree, carried by
    ``convert``: x, aux and the roped K / V at rtol 1e-5."""
    jcfg, tcfg = _block_cfgs("gemma3-27b")
    rng = np.random.default_rng(3)
    jp = jax.tree.map(
        lambda leaf: (rng.standard_normal(leaf.shape) * 0.2).astype(
            np.float32),
        jax.eval_shape(lambda k: JT.init_block(k, kind, jcfg),
                       jax.random.PRNGKey(0)))
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    jx, jaux, jkv = JT.block_apply(kind, jax.tree.map(jnp.asarray, jp),
                                   jnp.asarray(x), jcfg, {},
                                   return_kv=return_kv)
    tp = convert.params_from_jax(jp, device="cpu")
    tx_, taux, tkv = TT.block_apply(kind, tp, torch.from_numpy(x), tcfg, {},
                                    return_kv=return_kv)
    assert taux.dtype == torch.float32 and float(taux) == float(jaux) == 0.0
    pairs = [(tx_, jx)] + (list(zip(tkv, jkv)) if return_kv else [])
    assert (tkv is None) == (jkv is None)
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_block_api_kinds_and_refusals():
    assert TT.ATTN_KINDS == JT.ATTN_KINDS
    assert set(TT.PORTED_KINDS) <= set(TT.ATTN_KINDS)
    x = torch.zeros(1, 4, CFG.d_model)
    for kind in ("attn_moe", "enc", "mla_dense", "rwkv"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            TT.init_block(torch.Generator(), kind, CFG)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            TT.block_apply(kind, {}, x, CFG, {})


@pytest.mark.parametrize("remat", [False, True])
def test_forward_runs_each_layer_through_block_apply(monkeypatch, remat):
    """The block's math exists once: ``forward`` calls ``block_apply`` once
    per layer (with ``remat`` too: the count is of the forward pass)."""
    tcfg = dataclasses.replace(CFG, remat=remat,
                               schedule=((("attn",), 3),))
    params = TT.init_params(tcfg, 0, device="cpu")
    calls = []
    real = TT.block_apply

    def counted(kind, *a, **kw):
        calls.append(kind)
        return real(kind, *a, **kw)

    monkeypatch.setattr(TT, "block_apply", counted)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        2, CFG.vocab_size, (2, 16)))
    logits, aux = TT.forward(params, {"tokens": tokens}, tcfg)
    assert calls == ["attn"] * 3 and float(aux["moe_aux"]) == 0.0
    monkeypatch.setattr(TT, "block_apply", real)
    want, _ = TT.forward(params, {"tokens": tokens}, tcfg)
    assert torch.equal(logits, want)
