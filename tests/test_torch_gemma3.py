"""gemma3-27b in the port against the JAX package, on its smoke config.

The smoke config (d=128, 4 q heads over 2 kv heads of 32, 8 layers: 7
``local`` with a window of 8 and 1 global, qk-norm, tied embeddings, fp32
compute) with the JAX parameters carried over by ``params_from_jax``:
forward logits (rtol 1e-4: fp32, sums in other orders), the dense ring
cache after ``prefill`` for a prompt longer than the window, greedy
``ServeEngine.generate`` against stepwise argmax of full forwards (as the
JAX package's ``tests/test_serve_families.py``), and the greedy streams of
both engines equal to the JAX engines' token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_27b as jax_gemma
from repro.models import transformer as JT
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import Session as JaxSession
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine, ServeEngine, Session

JCFG = jax_gemma.SMOKE
CFG = get_config("gemma3-27b", smoke=True)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    jparams = JT.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                            device="cpu")


@pytest.fixture(scope="module")
def jfn():
    """The JAX functions the cases compare with, jitted once for the module
    (each compiles once per shape and is shared by the cases that call it;
    run eagerly, every op compiles and dispatches on its own)."""
    return {
        "forward": jax.jit(lambda p, toks: JT.forward(
            p, {"tokens": toks}, JCFG)[0]),
        "prefill": jax.jit(lambda p, toks: JT.prefill(
            p, {"tokens": toks}, JCFG, max_len=24)[:2]),
        "prefill_chunk": jax.jit(lambda p, scr, toks, start, take:
                                 JT.prefill_chunk(p, scr, toks, start, take,
                                                  JCFG)),
        "write": jax.jit(lambda pools, scr, ids, length:
                         JT.write_prefill_to_pools(pools, scr, ids, length,
                                                   4)),
        "decode": jax.jit(lambda p, pools, tok, pos, table, active:
                          JT.decode_step_paged(p, pools, tok, pos, table,
                                               active, JCFG, num_splits=2)),
    }


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_configs_match_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(get_config("gemma3-27b")) == \
        dataclasses.asdict(jax_gemma.CONFIG)
    assert CFG.block_kinds() == ("local", "attn") and CFG.use_qk_norm \
        and CFG.n_kv_heads < CFG.n_heads and CFG.tie_embeddings


def test_init_params_has_the_jax_leaves(params):
    _, tparams = params
    own = TT.init_params(CFG, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tparams.items()}
    assert own["segments/0/p0/attn/q_norm_scale"].shape == (1, CFG.hd)
    assert own["segments/1/p1/attn/k_norm_scale"].dtype == torch.float32
    assert "unembed/kernel" not in own


@pytest.mark.parametrize("s", [6, 20])
def test_forward_logits_match_jax(params, jfn, s):
    """20 tokens: every local layer masks past its window of 8."""
    jparams, tparams = params
    toks = np.random.default_rng(s).integers(0, CFG.vocab_size, (2, s))
    jlogits = jfn["forward"](jparams, jnp.asarray(toks, jnp.int32))
    tlogits, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks)}, CFG)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)


def test_dense_ring_cache_after_prefill_matches_jax(params, jfn):
    """A 13-token prompt past the window of 8: each local layer's cache is
    its last 8 positions at ring slots p % 8, the global layer's the whole
    prompt zero-padded to max_len."""
    jparams, tparams = params
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 13))
    jlast, jcache = jfn["prefill"](jparams, jnp.asarray(toks, jnp.int32))
    tlast, tcache, _ = TT.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                  CFG, max_len=24)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    want = convert.pools_from_jax(_np(jcache), device="cpu")
    assert set(tcache) == set(want)
    assert tcache["segments/0/p0/k"].shape == (1, 2, 8, 2, 32)
    assert tcache["segments/0/p5/k"].shape == (1, 2, 24, 2, 32)
    for key in want:
        np.testing.assert_allclose(tcache[key].numpy(), want[key].numpy(),
                                   **TOL, err_msg=key)
    zero = TT.init_cache(CFG, 2, 24, device="cpu")
    assert {k: v.shape for k, v in zero.items()} == \
        {k: v.shape for k, v in tcache.items()}


@pytest.mark.parametrize("s,new", [(6, 4), (7, 12)])
def test_generate_matches_stepwise_forward(params, s, new):
    """Greedy generation == argmax over repeated full forwards; (7, 12)
    wraps each local ring past the window."""
    _, tparams = params
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, CFG.vocab_size, (2, s)))
    got = ServeEngine(CFG, tparams, max_len=s + new).generate(
        {"tokens": toks}, max_new_tokens=new)
    for _ in range(new):
        logits, _ = TT.forward(tparams, {"tokens": toks}, CFG)
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert got.tolist() == toks[:, s:].tolist()


def test_dense_engine_greedy_stream_matches_jax(params):
    jparams, tparams = params
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 11))
    want = JaxServeEngine(JCFG, jparams, max_len=24).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, max_new_tokens=10)
    got = ServeEngine(CFG, tparams, max_len=24).generate(
        {"tokens": torch.from_numpy(toks)}, max_new_tokens=10)
    assert got.tolist() == np.asarray(want).tolist()


def _churn(engine_cls, session_cls, params, prompts, budgets):
    eng = engine_cls(CFG if engine_cls is PagedServeEngine else JCFG, params,
                     block_size=4, num_blocks=48, max_blocks_per_seq=8,
                     num_slots=2, max_prefill_len=16, prefill_chunk=8,
                     num_splits=2)
    sess = session_cls(eng, "churn")
    hs = [sess.submit(prompts[0], max_new_tokens=budgets[0]),
          sess.submit(prompts[1], max_new_tokens=budgets[1])]
    eng.step()
    eng.step()
    hs += [sess.submit(p, max_new_tokens=n)
           for p, n in zip(prompts[2:], budgets[2:])]
    eng.run()
    return eng, hs


def test_paged_engine_greedy_streams_match_jax(params):
    """Prompts of 5-14 tokens and up to 12 new ones: local layers read
    through flash_decode's window past the 8-token window."""
    jparams, tparams = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in (9, 5, 14, 7)]
    budgets = [12, 3, 10, 6]
    _, jhs = _churn(JaxPagedServeEngine, JaxSession, jparams, prompts,
                    budgets)
    eng, ths = _churn(PagedServeEngine, Session, tparams, prompts, budgets)
    for jh, th in zip(jhs, ths):
        assert th.tokens == jh.tokens, th.request.request_id
        assert th.finish_reason == jh.finish_reason == "length"
    s = eng.stats()
    assert s["running"] == 0 and s["free_blocks"] == 48


def test_paged_decode_and_prefill_chunks_match_jax(params, jfn):
    """One 14-token prompt chunk-prefilled (chunks of 8, past the window),
    then three paged decode steps: logits at rtol 1e-4."""
    jparams, tparams = params
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, 14)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :14] = prompt
    jscr = JT.init_prefill_scratch(JCFG, 16)
    tscr = TT.init_prefill_scratch(CFG, 16, device="cpu")
    for start in (0, 8):
        take = min(13 - start, 7)
        jl, jscr = jfn["prefill_chunk"](jparams, jscr, jnp.asarray(
            padded[:, start:start + 8]), start, take)
        tl, tscr = TT.prefill_chunk(tparams, tscr, torch.from_numpy(
            padded[:, start:start + 8]).long(), start, take, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    table = np.array([[2, 5, 1, 7, 0, 0]], np.int32)
    jpools = jfn["write"](JT.init_paged_pools(JCFG, 8, 4), jscr,
                          jnp.asarray(table[0]), 14)
    tpools = convert.pools_from_jax(_np(jpools), device="cpu")
    token = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    pos, active = np.array([14], np.int32), np.array([True])
    for _ in range(3):
        jlogits, jpools = jfn["decode"](
            jparams, jpools, jnp.asarray(token), jnp.asarray(pos),
            jnp.asarray(table), jnp.asarray(active))
        tlogits, tpools = TT.decode_step_paged(
            tparams, tpools, token, pos, torch.from_numpy(table), active,
            CFG, num_splits=2)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        token = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_cli_runs_gemma3_on_cpu(engine):
    from repro_torch.launch import serve as serve_cli
    res = serve_cli.run(serve_cli.build(
        ["--arch", "gemma3-27b", "--smoke", "--device", "cpu", "--engine",
         engine, "--batch", "2", "--prompt-len", "12", "--new-tokens", "6"]))
    if engine == "dense":
        assert len(res["tokens"]) == 2 and len(res["tokens"][0]) == 6
    else:
        assert res["stats"]["used_blocks"] == 0
