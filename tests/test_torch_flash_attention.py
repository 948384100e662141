"""The dense attention kernels of the port: ``flash_attention`` (the TPU
kernel's function) and ``flash_attention_blockwise`` (the JAX model's).

On the CPU each wrapper runs its plain version. ``flash_attention_ref`` is
held to the JAX package's Pallas ``flash_attention`` in interpret mode on
the six cases of ``tests/test_kernels.py`` at that test's tolerances (fp32
3e-5, bf16 2e-2), plus group 5, hd 96 and S = 777 (against JAX's
``ref.flash_attention_ref``: the Pallas kernel asserts S divides by its
blocks), and to JAX's ``blockwise_attention`` at 3e-5. The model's plain
version, ``blockwise_attention_ref``, is held to JAX's in bf16 in
``tests/test_torch_layers.py``; here its chunk rule, the route of the
model's ``blockwise_attention`` (by launch counter on the CPU, and with
spies in place of the launchers: bf16 to ``flash_attention_blockwise`` with
the model's ``kv_chunk``, fp32 to ``flash_attention``, grad calls to
neither, a query slice at a ``q_offset`` to the kernel with its offset)
and smoke-size prefill logits over
several kv chunks against JAX's. Keys of their own length (Skv != Sq, no
mask: an encoder's or a cross-attention's): both plain versions against
JAX's ``blockwise_attention`` at odd lengths and lengths off a multiple of
64, the route of such a call to the kernels (the blockwise chunk taken
from Skv, as each wrapper hands it to its C entry point), and the refusal
of a masked call with keys of another length.

The ``cuda``-marked tests hold each CUDA kernel to its plain version on the
card: for ``flash_attention`` the serving shapes, fp32, group 5, hd 96 and
17, S = 1 and 777, a window of 1; for ``flash_attention_blockwise`` hd 64,
96 and 128 (and 16, 256), odd S, chunks that are no tile multiple, fully
masked first chunks and strided views at the model's bar (max |d| <= 4e-3
max |out|, >= 99% bit-equal), both at keys of their own length (the
cross-attention shapes of whisper-large-v3 and llama-3.2-vision-90b, cut
in heads); relaunches bit-identical, and the route (a launch without grad,
none under grad, a slice at a ``q_offset`` launched, keys that do not
cover it refused). JAX is
imported inside the CPU tests only, so on a machine without JAX

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention.py

runs the card's tests.
"""
import importlib

import numpy as np
import pytest
import torch

# the modules: ``repro_torch.kernels`` exports wrappers of the same names
fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

# tests/test_kernels.py::test_flash_attention_matches_ref
KERNEL_CASES = [
    (2, 256, 4, 2, 64, True, None, "float32"),
    (1, 512, 8, 8, 128, True, None, "bfloat16"),
    (2, 256, 4, 1, 64, False, None, "float32"),
    (1, 512, 4, 2, 64, True, 128, "float32"),
    (1, 256, 2, 2, 32, True, 64, "bfloat16"),
    (3, 128, 6, 3, 64, True, None, "float32"),
]
# shapes the Pallas kernel cannot take: group 5, hd 96, a ragged S
REF_CASES = [
    (1, 64, 10, 2, 32, True, None, "float32"),
    (2, 48, 4, 2, 96, True, 16, "float32"),
    (1, 777, 4, 2, 32, True, 100, "float32"),
    (1, 777, 4, 4, 16, False, None, "bfloat16"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(b, s, hq, hkv, hd, dtype, seed=0):
    """q, k, v as numpy fp32, already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        x = torch.from_numpy(rng.standard_normal((b, s, h, hd))
                             .astype(np.float32))
        out.append(x.to(getattr(torch, dtype)).float().numpy())
    return out


def _jax_arrays(arrs, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _port(arrs, dtype, **kw):
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    out = fa.flash_attention(*ts, **kw)
    assert out.dtype == ts[0].dtype and out.shape == ts[0].shape
    return out.float().numpy()


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dtype", KERNEL_CASES)
def test_plain_matches_pallas_interpret(b, s, hq, hkv, hd, causal, window,
                                        dtype):
    from repro.kernels.flash_attention import flash_attention
    arrs = _inputs(b, s, hq, hkv, hd, dtype)
    want = flash_attention(*_jax_arrays(arrs, dtype), causal=causal,
                           window=window, block_q=128, block_k=128,
                           interpret=True)
    got = _port(arrs, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dtype", REF_CASES)
def test_plain_matches_jax_ref(b, s, hq, hkv, hd, causal, window, dtype):
    from repro.kernels.ref import flash_attention_ref
    arrs = _inputs(b, s, hq, hkv, hd, dtype, seed=1)
    want = flash_attention_ref(*_jax_arrays(arrs, dtype), causal=causal,
                               window=window)
    got = _port(arrs, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype])


def test_plain_matches_jax_blockwise():
    """tests/test_kernels.py::test_flash_attention_matches_blockwise_model_path
    on the port's plain version."""
    from repro.models.layers import blockwise_attention
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((2, 256, h, 64)).astype(np.float32)
            for h in (4, 2, 2)]
    want = blockwise_attention(*_jax_arrays(arrs, "float32"), causal=True,
                               q_chunk=64, kv_chunk=64)
    got = _port(arrs, "float32", causal=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5)


def test_model_attention_on_cpu_never_launches():
    """CPU tensors run the chunked loop, with or without grad, in fp32 and
    bf16."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 16,
                                                      "float32"))
    ops.reset_launch_counts(ops.ATTENTION)
    with torch.inference_mode():
        a = TL.blockwise_attention(q, k, v, causal=True, q_chunk=8,
                                   kv_chunk=8)
        a16 = TL.blockwise_attention(q.bfloat16(), k.bfloat16(),
                                     v.bfloat16(), causal=True, kv_chunk=8)
    b = TL.blockwise_attention(q.requires_grad_(), k, v, causal=True,
                               q_chunk=8, kv_chunk=8)
    assert ops.launch_counts(ops.ATTENTION) == {
        "flash_attention": 0, "flash_attention_blockwise": 0}
    torch.testing.assert_close(a, b.detach())
    torch.testing.assert_close(a, fa.flash_attention(q.detach(), k, v),
                               atol=3e-5, rtol=0)
    assert torch.equal(a16, fa.flash_attention_blockwise(
        q.detach().bfloat16(), k.bfloat16(), v.bfloat16(), kv_chunk=8))


@pytest.mark.parametrize("s,kv_chunk,want", [
    (1024, 512, 512), (2048, 1024, 1024), (700, 512, 700), (300, 512, 300),
    (512, 512, 512), (24, 8, 8), (20, 8, 20), (1, 512, 1)])
def test_effective_kv_chunk_is_the_loops(s, kv_chunk, want):
    """min(kv_chunk, S), or S when S is not a multiple of it (the JAX
    package's ``blockwise_attention``)."""
    assert fa.effective_kv_chunk(s, kv_chunk) == want


def _spy(calls, name, plain):
    def fn(q, k, v, **kw):
        calls.append((name, q.dtype, kw))
        return plain(q, k, v, **kw)
    return fn


def test_model_route_by_dtype_and_grad(monkeypatch):
    """With the device test patched to say "card", the route calls the
    bf16 kernel with the model's kv_chunk and the fp32 one without, and
    neither for a grad call; a no-grad query slice at a q_offset goes to the
    kernel with its offset, and a masked call whose keys do not cover its
    slice, which no kernel takes, raises; each result is the plain
    loop's."""
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention_blockwise", _spy(
        calls, "blockwise", fa.flash_attention_blockwise))
    monkeypatch.setattr(TL, "flash_attention_op", _spy(
        calls, "flash", fa.flash_attention))
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 16,
                                                      "bfloat16", seed=4))
    kw = dict(causal=True, window=12, q_chunk=8, kv_chunk=16)
    with torch.inference_mode():
        out16 = TL.blockwise_attention(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), **kw)
        out32 = TL.blockwise_attention(q, k, v, **kw)
        sl16 = TL.blockwise_attention(q[:, 16:].bfloat16(), k.bfloat16(),
                                      v.bfloat16(), q_offset=16, **kw)
        with pytest.raises(ValueError, match="no kernel"):
            TL.blockwise_attention(q[:, 16:].bfloat16(), k[:, :24].bfloat16(),
                                   v[:, :24].bfloat16(), q_offset=16, **kw)
    TL.blockwise_attention(q.bfloat16().requires_grad_(), k.bfloat16(),
                           v.bfloat16(), **kw)
    assert calls == [
        ("blockwise", torch.bfloat16,
         dict(causal=True, window=12, kv_chunk=16, q_offset=0)),
        ("flash", torch.float32, dict(causal=True, window=12, q_offset=0)),
        ("blockwise", torch.bfloat16,
         dict(causal=True, window=12, kv_chunk=16, q_offset=16))]
    assert torch.equal(sl16, out16[:, 16:])
    assert torch.equal(out16, fa.blockwise_attention_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw))
    torch.testing.assert_close(out32, fa.blockwise_attention_ref(
        q, k, v, **kw), atol=3e-5, rtol=0)


def test_blockwise_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="kv_chunk"):
        fa.flash_attention_blockwise(q, q, q, kv_chunk=0)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention_blockwise(q, torch.zeros(1, 8, 3, 16),
                                     torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_blockwise(q, q, q, window=0)


@pytest.mark.parametrize("arch", ["llama-350m", "gemma3-27b"])
def test_smoke_prefill_logits_match_jax(arch):
    """The smoke configs (kv_chunk 8) prefilled with 32 tokens: four kv
    chunks, and gemma3's local layers (window 8) mask whole chunks; last
    logits and every cache entry at the fp32 bar of the serving tests."""
    import jax

    from repro.configs import gemma3_27b as jax_gemma
    from repro.configs import llama_paper as jax_llama
    from repro.models import transformer as JT
    from repro_torch import convert
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TT

    jcfg = {"llama-350m": jax_llama.SMOKE, "gemma3-27b": jax_gemma.SMOKE}[arch]
    tcfg = get_config(arch, smoke=True)
    assert tcfg.kv_chunk == jcfg.kv_chunk == 8
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 32))
    jlast, jcache, _ = JT.prefill(jparams, {"tokens": toks.astype(np.int32)},
                                  jcfg, max_len=40)
    with torch.inference_mode():
        tlast, tcache, _ = TT.prefill(tparams, {"tokens": torch.from_numpy(
            toks)}, tcfg, max_len=40)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **tol)
    for key, want in convert.pools_from_jax(
            jax.tree.map(np.asarray, jcache), device="cpu").items():
        np.testing.assert_allclose(tcache[key].numpy(), want.numpy(), **tol,
                                   err_msg=key)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)


# (b, sq, skv, hq, hkv, hd, kv_chunk): keys of their own length, no mask;
# odd lengths, lengths off a multiple of 64, one query, a kv chunk that
# divides Skv (three chunks) and one that does not (one chunk of Skv)
SKV_CASES = [
    (2, 37, 150, 4, 2, 32, 1024),
    (1, 1, 77, 4, 4, 16, 8),
    (1, 100, 9, 6, 3, 64, 512),
    (2, 48, 96, 8, 2, 32, 32),
    (1, 20, 150, 4, 1, 32, 64),
]


def _skv_inputs(b, sq, skv, hq, hkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s, h in ((sq, hq), (skv, hkv), (skv, hkv)):
        x = torch.from_numpy(rng.standard_normal((b, s, h, hd))
                             .astype(np.float32))
        out.append(x.to(getattr(torch, dtype)).float().numpy())
    return out


@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,kv_chunk", SKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_take_keys_of_their_own_length(b, sq, skv, hq, hkv, hd,
                                                      kv_chunk, dtype):
    """Sq != Skv without a mask: ``blockwise_attention_ref`` (the blockwise
    kernel's plain version) against JAX's ``blockwise_attention`` on the
    same values at the bars of ``test_torch_layers.py`` (fp32 3e-5; bf16
    max |d| <= 4e-3 max |out|), and in fp32 ``flash_attention_ref`` too."""
    from repro.models.layers import blockwise_attention
    arrs = _skv_inputs(b, sq, skv, hq, hkv, hd, dtype, seed=sq + skv)
    want = np.asarray(blockwise_attention(
        *_jax_arrays(arrs, dtype), causal=False, q_chunk=512,
        kv_chunk=kv_chunk), np.float32)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    got = fa.blockwise_attention_ref(*ts, causal=False, kv_chunk=kv_chunk)
    assert got.shape == (b, sq, hq, hd) and got.dtype == ts[0].dtype
    tol = 3e-5 if dtype == "float32" else 4e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    if dtype == "float32":
        got = fa.flash_attention(*ts, causal=False)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


def test_masked_call_with_keys_of_another_length_is_refused(monkeypatch):
    """Both wrappers refuse a causal or windowed call whose keys have
    another length and do not cover its rows (fewer keys than queries:
    longer keys are a query slice at offset 0), and so does the route on
    the card (spies in place of the launchers: none is called)."""
    q, k = torch.zeros(1, 12, 4, 16), torch.zeros(1, 8, 2, 16)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="keys of their own length"):
            fa.flash_attention(q, k, k, **kw)
        with pytest.raises(ValueError, match="keys of their own length"):
            fa.flash_attention_blockwise(q, k, k, **kw)
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention_blockwise", _spy(
        calls, "blockwise", fa.flash_attention_blockwise))
    monkeypatch.setattr(TL, "flash_attention_op", _spy(
        calls, "flash", fa.flash_attention))
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="no kernel"):
                TL.blockwise_attention(q.to(dt), k.to(dt), k.to(dt),
                                       causal=True, kv_chunk=4)
    assert calls == []


def test_model_route_sends_cross_attention_to_the_kernels(monkeypatch):
    """A no-grad non-causal call with keys of their own length (a
    cross-attention's) goes to the bf16 kernel with the model's kv_chunk
    and to the fp32 one; under grad to neither; each result the loop's."""
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)
    monkeypatch.setattr(TL, "flash_attention_blockwise", _spy(
        calls, "blockwise", fa.flash_attention_blockwise))
    monkeypatch.setattr(TL, "flash_attention_op", _spy(
        calls, "flash", fa.flash_attention))
    q, k, v = (torch.from_numpy(a) for a in _skv_inputs(
        2, 21, 150, 4, 2, 32, "bfloat16", seed=8))
    kw = dict(causal=False, q_chunk=8, kv_chunk=64)
    with torch.inference_mode():
        out16 = TL.blockwise_attention(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), **kw)
        out32 = TL.blockwise_attention(q, k, v, **kw)
    TL.blockwise_attention(q.requires_grad_(), k, v, **kw)
    assert calls == [
        ("blockwise", torch.bfloat16,
         dict(causal=False, window=None, kv_chunk=64, q_offset=0)),
        ("flash", torch.float32, dict(causal=False, window=None, q_offset=0))]
    assert out16.shape == (2, 21, 4, 32)
    assert torch.equal(out16, fa.blockwise_attention_ref(
        q.detach().bfloat16(), k.bfloat16(), v.bfloat16(), **kw))
    torch.testing.assert_close(out32, fa.blockwise_attention_ref(
        q.detach(), k, v, **kw), atol=3e-5, rtol=0)


@pytest.mark.parametrize("sq,skv,kv_chunk,chunk", [
    (448, 1500, 1024, 1500), (2048, 6400, 1024, 6400),
    (64, 4096, 1024, 1024), (512, 512, 512, 512)])
def test_wrappers_hand_skv_and_its_chunk_to_the_kernel(monkeypatch, sq, skv,
                                                       kv_chunk, chunk):
    """What each wrapper passes its C entry point for keys of their own
    length, with the library replaced by a recorder (meta tensors: no
    memory, no card): Sq and Skv, and the blockwise kernel's chunk resolved
    from Skv by the model's rule (whisper's 1500 keys and vision's 6400,
    each one chunk), as many arguments as the entry point's signature;
    each launch counted."""
    from repro_torch.kernels import cuda_lib
    got = {}

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                got[name] = args
                return 0
            return entry

    monkeypatch.setattr(fa, "_check_heads", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_lib, "library", lambda: Lib())
    monkeypatch.setattr(cuda_lib, "stream", lambda t: 0)
    q = torch.empty(2, sq, 8, 64, device="meta")
    k = torch.empty(2, skv, 2, 64, device="meta")
    n32 = fa.flash_attention.launches
    n16 = fa.flash_attention_blockwise.launches
    out = fa.flash_attention(q, k, k, causal=False)
    out16 = fa.flash_attention_blockwise(q.bfloat16(), k.bfloat16(),
                                         k.bfloat16(), causal=False,
                                         kv_chunk=kv_chunk)
    assert out.shape == out16.shape == (2, sq, 8, 64)
    assert fa.flash_attention.launches == n32 + 1
    assert fa.flash_attention_blockwise.launches == n16 + 1
    a32 = got["repro_flash_attention"]
    a16 = got["repro_flash_attention_blockwise"]
    assert len(a32) == len(cuda_lib.SIGNATURES["repro_flash_attention"])
    assert len(a16) == len(cuda_lib.SIGNATURES[
        "repro_flash_attention_blockwise"])
    assert a32[4:10] == (2, sq, skv, 8, 2, 64)      # b, s, skv, hq, hkv, hd
    assert a16[4:11] == (2, sq, skv, 8, 2, 64, 64)  # ..., hd, vd
    assert a16[-3] == chunk


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, s, hq, hkv, hd, causal, window, dtype): the serving shapes at a
# shorter S, then the edge cases of chip_smoke.py's phase 12
CUDA_CASES = {
    "llama": (2, 512, 16, 16, 64, True, None, "bfloat16"),
    "gemma-local": (1, 1024, 32, 16, 128, True, 256, "bfloat16"),
    "gemma-global": (1, 1024, 32, 16, 128, True, None, "bfloat16"),
    "fp32": (2, 300, 8, 2, 64, True, None, "float32"),
    "group5": (1, 200, 10, 2, 64, True, 50, "float32"),
    "hd96": (2, 130, 4, 2, 96, True, None, "float32"),
    "hd17": (1, 70, 3, 1, 17, False, None, "float32"),
    "hd256": (1, 100, 2, 1, 256, True, None, "bfloat16"),
    "s1": (3, 1, 4, 2, 64, True, None, "float32"),
    "s777": (1, 777, 4, 2, 64, True, 100, "bfloat16"),
    "window1": (1, 129, 4, 4, 32, True, 1, "float32"),
    "noncausal-window": (1, 200, 4, 2, 32, False, 70, "float32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_kernel_matches_plain(cuda, name):
    b, s, hq, hkv, hd, causal, window, dtype = CUDA_CASES[name]
    ts = [torch.from_numpy(a).to(cuda, getattr(torch, dtype))
          for a in _inputs(b, s, hq, hkv, hd, dtype, seed=2)]
    before = fa.flash_attention.launches
    got = fa.flash_attention(*ts, causal=causal, window=window)
    again = fa.flash_attention(*ts, causal=causal, window=window)
    want = fa.flash_attention_ref(*ts, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert got.dtype == ts[0].dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views(cuda):
    """q, k, v as head-dim-contiguous views of one packed projection."""
    qkv = torch.randn(2, 96, 4 + 2 + 2, 32, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k,
                           v)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q, k.bfloat16(), v)


@pytest.mark.cuda
def test_cuda_route_launches_only_without_grad(cuda):
    """The model's attention launches the kernel for a no-grad call with
    q_offset 0 and Sq == Skv and for a query slice at a q_offset against
    keys covering it, runs the chunked loop under grad, and refuses a
    masked no-grad call whose keys do not cover its slice."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _inputs(1, 64, 4, 2, 32, "float32", seed=3))
    ops.reset_launch_counts(ops.ATTENTION)
    with torch.inference_mode():
        a = TL.blockwise_attention(q, k, v, causal=True, window=16,
                                   q_chunk=16, kv_chunk=16)
    assert fa.flash_attention.launches == 1
    b = TL.blockwise_attention(q.clone().requires_grad_(), k, v, causal=True,
                               window=16, q_chunk=16, kv_chunk=16)
    with torch.inference_mode():
        c = TL.blockwise_attention(q[:, 32:], k, v, causal=True, window=16,
                                   q_offset=32, q_chunk=16, kv_chunk=16)
    with torch.inference_mode(), pytest.raises(ValueError, match="no kernel"):
        TL.blockwise_attention(q[:, 32:], k[:, :48], v[:, :48], causal=True,
                               q_offset=32, q_chunk=16, kv_chunk=16)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 2
    torch.testing.assert_close(a, b.detach(), atol=3e-5, rtol=0)
    torch.testing.assert_close(c, b.detach()[:, 32:], atol=3e-5, rtol=0)


# (b, s, hq, hkv, hd, causal, window, kv_chunk) in bf16: the model's head
# dims, the prefill chunks, odd S, chunks that are no multiple of the
# kernel's 64-key tile, windows that mask whole first chunks, group 5
BLOCKWISE_CASES = {
    "llama-hd64": (2, 512, 16, 16, 64, True, None, 512),
    "two-chunks-hd64": (1, 1024, 4, 2, 64, True, None, 512),
    "phi3-hd96": (1, 384, 8, 8, 96, True, None, 128),
    "gemma-local-hd128": (1, 2048, 4, 2, 128, True, 256, 1024),
    "gemma-global-hd128": (1, 2048, 4, 2, 128, True, None, 1024),
    "odd-s": (2, 777, 4, 2, 64, True, 100, 512),
    "chunk-100-window-50": (1, 300, 4, 2, 64, True, 50, 100),
    "chunk-8": (1, 40, 4, 2, 32, True, 8, 8),
    "group5-window": (1, 320, 10, 2, 64, True, 64, 64),
    "noncausal-window": (1, 200, 4, 2, 64, False, 70, 64),
    "noncausal": (2, 130, 6, 3, 128, False, None, 512),
    "hd16-s1": (3, 1, 4, 2, 16, True, None, 512),
    "hd256": (1, 200, 2, 1, 256, True, None, 64),
}
MODEL_REL_TOL, MODEL_MIN_EQUAL = 4e-3, 0.99


def _model_bar(got, want):
    """tests/test_torch_layers.py's bar: max |d| <= 4e-3 max |out|, at
    least 99% of the elements bit-equal."""
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= MODEL_REL_TOL * want.float().abs().max().item()
    assert (d == 0).float().mean().item() >= MODEL_MIN_EQUAL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BLOCKWISE_CASES))
def test_cuda_blockwise_kernel_matches_plain(cuda, name):
    b, s, hq, hkv, hd, causal, window, chunk = BLOCKWISE_CASES[name]
    ts = [torch.from_numpy(a).to(cuda, torch.bfloat16)
          for a in _inputs(b, s, hq, hkv, hd, "bfloat16", seed=5)]
    kw = dict(causal=causal, window=window, kv_chunk=chunk)
    before = fa.flash_attention_blockwise.launches
    got = fa.flash_attention_blockwise(*ts, **kw)
    again = fa.flash_attention_blockwise(*ts, **kw)
    want = fa.blockwise_attention_ref(*ts, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_blockwise.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == ts[0].shape
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    _model_bar(got, want)


@pytest.mark.cuda
def test_cuda_blockwise_kernel_reads_strided_views(cuda):
    """q, k, v as views of one packed bf16 projection (rows on 16 bytes);
    a head dim that is no multiple of 16, a strided head dim, fp32 or a row
    off 16 bytes are refused."""
    qkv = torch.randn(2, 200, 4 + 2 + 2, 64, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    kw = dict(causal=True, window=96, kv_chunk=64)
    got = fa.flash_attention_blockwise(q, k, v, **kw)
    want = fa.flash_attention_blockwise(q.contiguous(), k.contiguous(),
                                        v.contiguous(), **kw)
    assert torch.equal(got, want)
    _model_bar(got, fa.blockwise_attention_ref(q, k, v, **kw))
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention_blockwise(q[..., :40], k[..., :40], v[..., :40])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_blockwise(q.transpose(1, 3).contiguous()
                                     .transpose(1, 3), k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_blockwise(q.float(), k.float(), v.float())
    flat = torch.zeros(1 + 2 * 64 * 4 * 64, device=cuda).bfloat16()
    off = flat[1:].view(2, 64, 4, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention_blockwise(off, off, off)


@pytest.mark.cuda
def test_cuda_route_bf16_launches_blockwise(cuda):
    """A bf16 no-grad call of the model's attention launches the blockwise
    kernel with the model's kv_chunk, and its result is the plain loop's
    at the model's bar; under grad the loop runs."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(1, 256, 4, 2, 64, "bfloat16", seed=6))
    ops.reset_launch_counts(ops.ATTENTION)
    kw = dict(causal=True, window=100, q_chunk=64, kv_chunk=128)
    with torch.inference_mode():
        a = TL.blockwise_attention(q, k, v, **kw)
    assert ops.launch_counts(ops.ATTENTION) == {
        "flash_attention": 0, "flash_attention_blockwise": 1}
    b = TL.blockwise_attention(q.clone().requires_grad_(), k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_blockwise.launches == 1
    _model_bar(a, b.detach())
