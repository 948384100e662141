"""The DeepSeek MoE family in the port against the JAX package, at the smoke
configs (d=128, 4 heads, 8 experts top-2, fp32, ``capacity_factor`` 8.0:
drop-free): deepseek-moe-16b (one ``attn`` layer and one ``attn_moe``: 2
shared experts) and deepseek-v3-671b (one ``mla_dense`` and one
``mla_moe`` layer: MLA with a q / k head dim of 48 beside a v head dim of
32, one shared expert, the MTP head).

Parameters are drawn by numpy into JAX's tree (``torch_dense_parity.pair``)
and carried over by ``convert``. The bars: logits, ``mtp_logits`` and every
gradient at rtol 1e-4 (the bars of ``test_torch_model_train.py``; fp32,
sums in other orders), ``moe_aux`` and the losses at rtol 1e-5;
prefill + decode against the forward at rtol 1e-4 (JAX's own
``test_arch_smoke.py`` holds its package to atol 2e-3 / rtol 1e-3 there),
the caches and decode logits against JAX's at rtol 1e-4; greedy streams
token for token; 5-step DCT-AdamW trajectories at ``TRAJECTORY_RTOL``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 - autouse
import torch_dense_parity as P

from repro.configs import deepseek_moe_16b as jax_dsm
from repro.configs import deepseek_v3_671b as jax_dsv3
from repro.data.synthetic import SyntheticLM
from repro.models import transformer as JT
from repro.optim.api import get_optimizer as jax_get_optimizer
from repro.train import steps as JS
from repro.train.schedule import cosine_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim.api import get_optimizer
from repro_torch.serve import PagedServeEngine, ServeEngine, Session
from repro_torch.train import steps as TS
from repro_torch.train.schedule import cosine_warmup


MODULES = {"deepseek-moe-16b": jax_dsm, "deepseek-v3-671b": jax_dsv3}
ARCHS = list(MODULES)
TOL = P.TOL
fa = importlib.import_module("repro_torch.kernels.flash_attention")
#: the prompt of the forward, prefill and decode comparisons
SEQ = 24
# 5 DCT-AdamW steps (rank 16: the top-16 of each leaf's 64 or 128 DCT
# columns reselected every step, lr 0.01, cosine warmup 2) on the JAX
# package's synthetic batches: the frameworks' fp32 sums part ~1e-7 per op
# and the selection and int8 EF rounding amplify them; measured 1.65e-5
# (deepseek-moe-16b) and 3.8e-6 (deepseek-v3-671b) relative at worst over
# the 5 steps (this file's case on the CPU)
TRAJECTORY_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """``{arch: (jax cfg, port cfg, jax params, port params)}`` at the smoke
    size, parameters drawn by numpy into JAX's tree."""
    return {arch: (mod.SMOKE, get_config(arch, smoke=True),
                   *P.pair(mod.SMOKE, seed=3))
            for arch, mod in MODULES.items()}


@pytest.fixture(scope="module")
def jfn():
    """JAX's functions, jitted once per arch for the module."""
    out = {}
    for arch, mod in MODULES.items():
        cfg = mod.SMOKE
        out[arch] = {
            "forward": jax.jit(lambda p, toks, cfg=cfg: JT.forward(
                p, {"tokens": toks}, cfg)),
            "grad": jax.jit(lambda p, b, cfg=cfg: jax.value_and_grad(
                JS.loss_fn, has_aux=True)(p, b, cfg)),
            "prefill": jax.jit(lambda p, toks, cfg=cfg: JT.prefill(
                p, {"tokens": toks}, cfg, max_len=SEQ + 4)[:2]),
            "decode": jax.jit(lambda p, c, tok, pos, cfg=cfg: JT.decode_step(
                p, c, tok, pos, cfg)),
        }
    return out


def _tokens(cfg, seed, s=SEQ + 1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    P.configs_match(arch, MODULES[arch])
    cfg = get_config(arch)
    assert cfg.family == "moe" and set(cfg.block_kinds()) <= \
        set(TT.PORTED_KINDS)
    smoke = get_config(arch, smoke=True)
    assert smoke.capacity_factor == 8.0 and smoke.n_experts == 8


@pytest.mark.parametrize("arch,lo,hi", [("deepseek-moe-16b", 16e9, 17e9),
                                        ("deepseek-v3-671b", 670e9, 690e9)])
def test_full_config_on_meta_matches_jax_eval_shape(arch, lo, hi):
    n = P.full_config_matches_eval_shape(arch, MODULES[arch])
    assert lo < n < hi


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax_leaves(models, arch):
    jcfg, tcfg, jp, _ = models[arch]
    P.smoke_leaves_match(jp, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_aux_loss_grads_match_jax(models, jfn, arch):
    """Logits, ``moe_aux``, ``mtp_logits``, the loss with its ``ce`` /
    ``mtp_ce`` parts, and the gradient of every leaf."""
    jcfg, tcfg, jp, tp = models[arch]
    toks = _tokens(jcfg, 0)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jaux = jfn[arch]["forward"](jp, jnp.asarray(batch["tokens"],
                                                    jnp.int32))
    tl, taux = TT.forward(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                          tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    assert float(jaux["moe_aux"]) > 0
    np.testing.assert_allclose(float(taux["moe_aux"]),
                               float(jaux["moe_aux"]), rtol=1e-5)
    assert (taux["mtp_logits"] is None) == (jaux["mtp_logits"] is None) \
        == (not jcfg.mtp)
    if jcfg.mtp:
        np.testing.assert_allclose(taux["mtp_logits"].detach().numpy(),
                                   np.asarray(jaux["mtp_logits"]), **TOL)
    (jloss, jm), jg = jfn[arch]["grad"](jp, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.int32), batch))
    tg, tm = TS.grad_fn(tp, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, tcfg)
    assert set(tm) == set(jm) == ({"ce", "loss", "mtp_ce"} if jcfg.mtp
                                  else {"ce", "loss"})
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg),
                                   device="cpu")
    assert set(tg) == set(want)
    for path, g in tg.items():
        ref = want[path].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward_and_jax(models, jfn, arch):
    """``prefill`` of SEQ - 4 tokens and 4 ``decode_step``s equal the
    forward's logits at those positions, and JAX's prefill and decode
    (logits and every cache entry: MLA's latent ``ckv`` / ``krope``)."""
    jcfg, tcfg, jp, tp = models[arch]
    toks = _tokens(jcfg, 1, SEQ)
    full, _ = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    n = SEQ - 4
    with torch.inference_mode():
        last, cache, _ = TT.prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :n])}, tcfg, max_len=SEQ + 4)
    jlast, jcache = jfn[arch]["prefill"](jp, jnp.asarray(toks[:, :n],
                                                         jnp.int32))
    names = {"k", "v"} if arch == "deepseek-moe-16b" else {"ckv", "krope"}
    assert {key.rsplit("/", 1)[1] for key in cache} == names
    steps = [(last, jlast)]
    for i in range(n, SEQ):
        tok = toks[:, i]
        for key, want in convert.pools_from_jax(
                jax.tree.map(np.asarray, jcache), device="cpu").items():
            np.testing.assert_allclose(cache[key].numpy(), want.numpy(),
                                       **TOL, err_msg=key)
        with torch.inference_mode():
            lg, cache = TT.decode_step(tp, cache, torch.from_numpy(tok), i,
                                       tcfg)
        jlg, jcache = jfn[arch]["decode"](jp, jcache, jnp.asarray(
            tok, jnp.int32), jnp.int32(i))
        steps.append((lg, jlg))
    for j, (got, want) in enumerate(steps):
        pos = n - 1 + j
        np.testing.assert_allclose(got.numpy(), full[:, pos].detach().numpy(),
                                   **TOL, err_msg=f"position {pos}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"position {pos}")


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_stream_matches_jax(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    P.dense_stream(jp, tp, jcfg, tcfg, prompt=20, new=6)


def test_moe_paged_engine_matches_dense_engine_and_jax(models):
    """deepseek-moe-16b: the paged engine's greedy streams equal the dense
    engine's for the same prompts (drop-free routing: a token's output does
    not depend on its batch), and JAX's paged engine's under churn."""
    jcfg, tcfg, jp, tp = models["deepseek-moe-16b"]
    prompts = _tokens(tcfg, 4, 20)
    dense = ServeEngine(tcfg, tp, max_len=28).generate(
        {"tokens": torch.from_numpy(prompts)}, max_new_tokens=8)
    eng = PagedServeEngine(tcfg, tp, block_size=8, num_blocks=16,
                           max_blocks_per_seq=4, num_slots=3,
                           max_prefill_len=24, prefill_chunk=8)
    sess = Session(eng, "moe")
    hs = [sess.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert [h.tokens for h in hs] == dense.tolist()
    P.paged_streams(jp, tp, jcfg, tcfg)


def test_moe_paged_chunks_and_decode_match_jax(models):
    jcfg, tcfg, jp, tp = models["deepseek-moe-16b"]
    P.paged_chunks_and_decode(jp, tp, jcfg, tcfg)


def test_mla_refuses_the_paged_engine(models):
    """MLA keeps the dense engine, as in the JAX package: its pools raise
    with JAX's message, and so does the serving CLI's paged engine."""
    from repro_torch.launch import serve as serve_cli
    _, tcfg, _, tp = models["deepseek-v3-671b"]
    assert not TT.paged_supported(tcfg)
    with pytest.raises(ValueError, match="use the dense ServeEngine"):
        PagedServeEngine(tcfg, tp)
    with pytest.raises(SystemExit, match="use the dense ServeEngine"):
        serve_cli.run(serve_cli.build(["--arch", "deepseek-v3-671b",
                                       "--smoke", "--device", "cpu"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_five_step_dct_adamw_trajectory_matches_jax(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    kw = dict(rank=16, weight_decay=0.01)
    jopt = jax_get_optimizer("dct_adamw", lr=jax_cosine(0.01, 2, 5), **kw)
    topt = get_optimizer("dct_adamw", lr=cosine_warmup(0.01, 2, 5), **kw)
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    tstate = TS.TrainState(0, tp, topt.init(tp))
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    data = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=16,
                       global_batch=4)
    jl, tl = [], []
    for i in range(5):
        b = {k: np.array(v) for k, v in data.batch(jnp.int32(i)).items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=TRAJECTORY_RTOL)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("arch,engine", [("deepseek-moe-16b", "dense"),
                                         ("deepseek-moe-16b", "paged"),
                                         ("deepseek-moe-16b", "train"),
                                         ("deepseek-v3-671b", "dense"),
                                         ("deepseek-v3-671b", "train")])
def test_clis_run_on_cpu(arch, engine):
    P.cli_runs(arch, engine)


def test_mla_prefill_routes_bf16_to_the_blockwise_kernel(monkeypatch):
    """With the device test patched to say "card", an MLA-shaped no-grad
    bf16 call (q / k head dim 48, v 32) goes to ``flash_attention_blockwise``
    (on the CPU its plain version: the chunked loop's output, of v's head
    dim), and an fp32 one raises instead of running the loop."""
    calls = []
    monkeypatch.setattr(TL, "_on_card", lambda t: True)

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return fa.flash_attention_blockwise(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention_blockwise", spy)
    rng = np.random.default_rng(6)
    q, k = (torch.from_numpy(rng.standard_normal((2, 16, 4, 48)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 16, 4, 32)).astype(
        np.float32))
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    with torch.inference_mode():
        out = TL.blockwise_attention(q.bfloat16(), k.bfloat16(),
                                     v.bfloat16(), **kw)
        with pytest.raises(ValueError, match="value dim 32 != head dim 48"):
            TL.blockwise_attention(q, k, v, **kw)
    assert calls == [((2, 16, 4, 48), (2, 16, 4, 32))]
    assert out.shape == (2, 16, 4, 32)
    assert torch.equal(out, fa.blockwise_attention_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, k, v)


def test_mla_bf16_forward_matches_jax():
    """deepseek-v3's MLA and MTP head in bf16 compute (fp32 parameters cast
    at use, the MLA norm scales kept in fp32), two ``mla_dense`` layers: no
    MoE, whose discrete routing flips a token's experts where the two
    packages' bf16 roundings part (measured: one position of 48 at the
    smoke size). Logits and ``mtp_logits`` within 2e-2 of max |logit|: both
    packages round each product and activation to bf16 in other orders
    (measured 9.9e-3 and 1.14e-2, about one bf16 ulp at the top; this case
    on the CPU)."""
    sched = ((("mla_dense",), 2),)
    jcfg = dataclasses.replace(jax_dsv3.SMOKE, schedule=sched,
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                               schedule=sched, compute_dtype="bfloat16")
    jp, tp = P.pair(jcfg, seed=5)
    toks = _tokens(jcfg, 7, SEQ)
    jl, jaux = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, taux = TT.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tl.dtype == torch.bfloat16
    for got, want in ((tl, jl), (taux["mtp_logits"], jaux["mtp_logits"])):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(got.detach().float().numpy() - want).max() <= \
            2e-2 * np.abs(want).max()
