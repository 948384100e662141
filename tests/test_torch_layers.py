"""The port's attention functions in bf16 against the JAX package's on the
same bf16 values.

The JAX package multiplies bf16 operands with ``preferred_element_type=
float32``: exact products, fp32 sums, never rounded to bf16 before the
softmax or the output. The port must do the same. What may differ is the
order of the fp32 sums, so an output element may round to a neighbouring
bf16 value: each case holds max |port - JAX| <= 4e-3 * max |out| (about
one bf16 ulp of the largest output) with at least 99% of the elements
bit-equal. Rounding a product to bf16, as the port's chunked loop did,
breaks both (on the first case 0.0047 and 61% of elements differ).

The dense prefill's function, ``flash_attention_blockwise`` (its plain
version on the CPU), is held to JAX's ``blockwise_attention`` at the same
bar on the model's chunk sizes: two chunks of 512 (llama), two of 1024
with a window of 256 (gemma3: rows whose first chunk is all masked), and
S = 700, one chunk. The TPU kernel's function (``flash_attention_ref``: P
unrounded, one max over the sequence) misses the bar on the first of them.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
# the modules: ``repro_torch.kernels`` exports wrappers of the same names
fa = importlib.import_module("repro_torch.kernels.flash_attention")

REL_TOL, MIN_EQUAL = 4e-3, 0.99


def _bf16(shape, rng):
    """The same bf16 values for both packages: (jax array, torch tensor)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).bfloat16()
    return jnp.asarray(x.float().numpy(), jnp.bfloat16), x


def _gap(got, want):
    """(max |got - want| / max |want|, share of elements bit-equal)."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), (d == 0).mean()


def _check(got, want):
    rel, equal = _gap(got, want)
    assert rel <= REL_TOL, rel
    assert equal >= MIN_EQUAL, equal


# (b, s, hq, hkv, hd, causal, window, chunk)
BLOCKWISE = {
    "gqa-causal": (2, 256, 8, 4, 64, True, None, 64),
    "gqa-window": (1, 512, 8, 4, 128, True, 128, 64),
    "mha-full": (2, 128, 4, 4, 32, False, None, 32),
    "group5-window": (1, 192, 10, 2, 64, True, 48, 64),
}


@pytest.mark.parametrize("name", list(BLOCKWISE))
def test_blockwise_attention_bf16_matches_jax(name):
    b, s, hq, hkv, hd, causal, window, chunk = BLOCKWISE[name]
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16((b, s, h, hd), rng)
                                    for h in (hq, hkv, hkv))
    want = JL.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                  q_chunk=chunk, kv_chunk=chunk)
    got = TL.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                 q_chunk=chunk, kv_chunk=chunk)
    assert got.dtype == torch.bfloat16
    _check(got, want)


# (b, s, hq, hkv, hd, window)
DECODE = {"gqa": (4, 300, 8, 4, 64, None), "gqa-window": (3, 512, 8, 2, 128, 128),
          "mha": (2, 64, 4, 4, 32, None)}


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_attention_bf16_matches_jax(name):
    b, s, hq, hkv, hd, window = DECODE[name]
    rng = np.random.default_rng(1)
    jq, tq = _bf16((b, hq, hd), rng)
    (jk, tk), (jv, tv) = (_bf16((b, s, hkv, hd), rng) for _ in range(2))
    length = rng.integers(1, s + 1, b)
    want = JL.decode_attention(jq, jk, jv, length=jnp.asarray(length),
                               window=window)
    got = TL.decode_attention(tq, tk, tv, length=torch.from_numpy(length),
                              window=window)
    _check(got, want)


# (b, c, start, hq, hkv, hd, window): a chunk at ``start`` against a cache
# of start + c positions
CHUNK = {"gqa": (1, 64, 192, 8, 4, 64, None),
         "gqa-window": (2, 128, 256, 8, 2, 128, 100),
         "mha": (1, 32, 0, 4, 4, 32, None)}


@pytest.mark.parametrize("name", list(CHUNK))
def test_chunk_attention_bf16_matches_jax(name):
    b, c, start, hq, hkv, hd, window = CHUNK[name]
    rng = np.random.default_rng(2)
    jq, tq = _bf16((b, c, hq, hd), rng)
    (jk, tk), (jv, tv) = (_bf16((b, start + c, hkv, hd), rng)
                          for _ in range(2))
    qpos = np.arange(start, start + c)[:, None]
    kpos = np.arange(start + c)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos >= qpos - window + 1
    want = JL.chunk_attention(jq, jk, jv, jnp.asarray(mask))
    got = TL.chunk_attention(tq, tk, tv, torch.from_numpy(mask))
    _check(got, want)


# (b, s, hq, hkv, hd, causal, window, kv_chunk): the model's chunk sizes
MODEL_CHUNKS = {
    "two-chunks-gqa-causal": (1, 1024, 4, 2, 64, True, None, 512),
    "two-chunks-window-hd128": (1, 2048, 2, 1, 128, True, 256, 1024),
    "one-chunk-s700": (1, 700, 4, 2, 64, True, None, 512),
}


def _model_case(name, seed=3):
    b, s, hq, hkv, hd, causal, window, chunk = MODEL_CHUNKS[name]
    rng = np.random.default_rng(seed)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16((b, s, h, hd), rng)
                                    for h in (hq, hkv, hkv))
    want = JL.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                  q_chunk=512, kv_chunk=chunk)
    return (tq, tk, tv), dict(causal=causal, window=window), chunk, want


@pytest.mark.parametrize("name", list(MODEL_CHUNKS))
def test_prefill_attention_plain_matches_jax(name):
    """The dense prefill route's function on the CPU (its plain version)
    against JAX's bf16 ``blockwise_attention`` at the model's chunk."""
    (q, k, v), kw, chunk, want = _model_case(name)
    got = fa.flash_attention_blockwise(q, k, v, kv_chunk=chunk, **kw)
    assert got.dtype == torch.bfloat16
    _check(got, want)


def test_tpu_kernel_function_misses_the_model_bar():
    """The fault the blockwise route repairs: the TPU kernel's function (P
    unrounded before P.V, one max over all keys) is not the JAX model's
    in bf16, where the route's function is."""
    (q, k, v), kw, chunk, want = _model_case("two-chunks-gqa-causal")
    rel, equal = _gap(fa.flash_attention_ref(q, k, v, **kw), want)
    assert rel > REL_TOL or equal < MIN_EQUAL, (rel, equal)
    _check(fa.flash_attention_blockwise(q, k, v, kv_chunk=chunk, **kw), want)
