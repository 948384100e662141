"""The serving slice against the JAX package, and the serving invariants of
``tests/test_serve_paged.py`` on the port.

Parity on the smoke llama (d=128, one layer, fp32 compute) and a GQA
variant with two kv heads, from the same parameters (``params_from_jax``):
chunked-prefill logits and scratch, the scatter of a scratch into the
pools (exact), paged decode logits over several steps with slots going
inactive (rtol 1e-4: fp32, sums in other orders), the dense prefill and
decode path, and the greedy token streams of ``PagedServeEngine`` under
one churn scenario (equal token for token). The JAX side's flash decode is
its Pallas kernel in interpret mode.

Port-only invariants: churned streams equal dense solo runs, a surviving
slot's logits are bit-for-bit unchanged by churn, backpressure queues and
never drops, cancellation returns blocks, eos is per request, and a
sampled stream depends only on its seed and positions.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama_paper as jax_llama
from repro.models import transformer as JT
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import Session as JaxSession
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as TT
from repro_torch.serve import (PagedServeEngine, SamplingParams, ServeEngine,
                               Session)
from repro_torch.serve.session import fold_keys, sample_tokens

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("llama-350m", smoke=True)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    over = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_llama.SMOKE, **over)
    tcfg = dataclasses.replace(CFG, **over)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def gqa(request):
    tcfg = dataclasses.replace(CFG, n_kv_heads=2)
    return tcfg, TT.init_params(tcfg, seed=0, device="cpu"), None


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_prefill(jcfg, jparams, prompt, chunk, max_len):
    scratch = JT.init_prefill_scratch(jcfg, max_len)
    padded = np.zeros((1, max_len), np.int32)
    padded[0, :len(prompt)] = prompt
    out = []
    for start in range(0, len(prompt), chunk):
        take = max(min(len(prompt) - 1 - start, chunk - 1), 0)
        logits, scratch = JT.prefill_chunk(
            jparams, scratch, jnp.asarray(padded[:, start:start + chunk]),
            start, take, jcfg)
        out.append((np.asarray(logits), _np(scratch)))
    return out, scratch


def test_prefill_chunks_and_pool_scatter_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, tcfg.vocab_size, 11).astype(np.int32)
    chunks, jscratch = _jax_prefill(jcfg, jparams, prompt, 8, 16)
    scratch = TT.init_prefill_scratch(tcfg, 16, device="cpu")
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :11] = torch.from_numpy(prompt)
    for (jlogits, jscr), start in zip(chunks, (0, 8)):
        take = max(min(10 - start, 7), 0)
        logits, scratch = TT.prefill_chunk(tparams, scratch,
                                           padded[:, start:start + 8], start,
                                           take, tcfg)
        np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
        for key, want in convert.pools_from_jax(jscr, device="cpu").items():
            np.testing.assert_allclose(scratch[key].numpy(), want.numpy(),
                                       **TOL, err_msg=key)
    # the scatter of the same scratch into the pools is exact
    ids = np.array([3, 7, 1, 0, 0, 0], np.int32)
    jpools = JT.write_prefill_to_pools(JT.init_paged_pools(jcfg, 16, 4),
                                       jscratch, jnp.asarray(ids), 11, 4)
    tpools = TT.write_prefill_to_pools(
        TT.init_paged_pools(tcfg, 16, 4, device="cpu"),
        convert.pools_from_jax(_np(jscratch), device="cpu"), ids, 11, 4)
    want = convert.pools_from_jax(_np(jpools), device="cpu")
    assert set(tpools) == set(want) == {"segments/0/p0/k", "segments/0/p0/v"}
    for key in want:
        assert torch.equal(tpools[key], want[key]), key


def test_decode_step_paged_matches_jax(pair):
    """Two slots prefilled into shared pools, then three decode steps (the
    second slot inactive in the last): logits at rtol 1e-4, pools close."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (11, 6)]
    blocks = [[3, 7, 1, 5], [2, 9, 4]]
    table = np.zeros((2, 6), np.int32)
    jpools = JT.init_paged_pools(jcfg, 16, 4)
    tokens = []
    for i, (p, b) in enumerate(zip(prompts, blocks)):
        table[i, :len(b)] = b
        chunks, scr = _jax_prefill(jcfg, jparams, p, 8, 16)
        jpools = JT.write_prefill_to_pools(jpools, scr, jnp.asarray(table[i]),
                                           len(p), 4)
        tokens.append(int(np.argmax(chunks[-1][0][0])))
    tpools = convert.pools_from_jax(_np(jpools), device="cpu")
    pos = np.array([11, 6], np.int32)
    token = np.array(tokens, np.int32)
    for step, active in enumerate(([True, True], [True, True],
                                   [True, False])):
        active = np.array(active)
        jlogits, jpools = JT.decode_step_paged(
            jparams, jpools, jnp.asarray(token), jnp.asarray(pos),
            jnp.asarray(table), jnp.asarray(active), jcfg, num_splits=2)
        tlogits, tpools = TT.decode_step_paged(
            tparams, tpools, token, pos, torch.from_numpy(table), active,
            tcfg, num_splits=2)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"step {step}")
        for key, want in convert.pools_from_jax(_np(jpools),
                                                device="cpu").items():
            np.testing.assert_allclose(tpools[key].numpy(), want.numpy(),
                                       **TOL, err_msg=key)
        token = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
        pos = pos + 1


def test_dense_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    jlast, jcache, n = JT.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                  jcfg, max_len=16)
    tlast, tcache, m = TT.prefill(tparams, {"tokens": torch.from_numpy(
        prompt).long()}, tcfg, max_len=16)
    assert n == m == 9
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    for key, want in convert.pools_from_jax(_np(jcache), device="cpu").items():
        assert tcache[key].shape == want.shape == (1, 2, 16, tcfg.n_kv_heads,
                                                   tcfg.hd)
        np.testing.assert_allclose(tcache[key].numpy(), want.numpy(), **TOL)
    zero = TT.init_cache(tcfg, 2, 16, device="cpu")
    assert {k: v.shape for k, v in zero.items()} == \
        {k: v.shape for k, v in tcache.items()}
    token = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)
    pos = np.array([9, 9], np.int32)
    for _ in range(2):
        jlogits, jcache = JT.decode_step(jparams, jcache, jnp.asarray(token),
                                         jnp.asarray(pos), jcfg)
        tlogits, tcache = TT.decode_step(tparams, tcache,
                                         torch.from_numpy(token).long(),
                                         torch.from_numpy(pos).long(), tcfg)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **TOL)
        token = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
        pos = pos + 1


def _churn(engine_cls, session_cls, cfg, params, prompts, budgets):
    eng = engine_cls(cfg, params, block_size=4, num_blocks=32,
                     max_blocks_per_seq=6, num_slots=2, max_prefill_len=16,
                     prefill_chunk=8, num_splits=2)
    sess = session_cls(eng, "churn")
    hs = [sess.submit(prompts[0], max_new_tokens=budgets[0]),
          sess.submit(prompts[1], max_new_tokens=budgets[1])]
    eng.step()
    eng.step()
    hs += [sess.submit(p, max_new_tokens=n)
           for p, n in zip(prompts[2:], budgets[2:])]
    eng.run()
    return eng, hs


CHURN_LENS, CHURN_BUDGETS = (9, 5, 11, 7), [6, 3, 5, 4]


def test_paged_engine_greedy_streams_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)) for n in CHURN_LENS]
    _, jhs = _churn(JaxPagedServeEngine, JaxSession, jcfg, jparams, prompts,
                    CHURN_BUDGETS)
    eng, ths = _churn(PagedServeEngine, Session, tcfg, tparams, prompts,
                      CHURN_BUDGETS)
    for jh, th in zip(jhs, ths):
        assert th.tokens == jh.tokens, th.request.request_id
        assert th.finish_reason == jh.finish_reason == "length"
    s = eng.stats()
    assert s["running"] == 0 and s["free_blocks"] == 32


def _dense_solo(dense, prompt, new, eos_id=None):
    out = dense.generate({"tokens": torch.from_numpy(
        np.asarray(prompt)[None]).long()}, max_new_tokens=new, eos_id=eos_id)
    return out[0].tolist()


@pytest.mark.parametrize("over", list(VARIANTS))
def test_churn_matches_dense_solo(over):
    cfg = dataclasses.replace(CFG, **VARIANTS[over])
    params = TT.init_params(cfg, seed=0, device="cpu")
    dense = ServeEngine(cfg, params, max_len=48)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in CHURN_LENS]
    _, hs = _churn(PagedServeEngine, Session, cfg, params, prompts,
                   CHURN_BUDGETS)
    for h, p, n in zip(hs, prompts, CHURN_BUDGETS):
        assert h.tokens == _dense_solo(dense, p, n), h.request.request_id


def test_surviving_slot_logits_bit_for_bit(gqa):
    cfg, params, _ = gqa
    rng = np.random.default_rng(1)
    prompt_a, prompt_b, prompt_c = (rng.integers(0, cfg.vocab_size, (n,))
                                    for n in (9, 6, 4))

    def run(churn):
        eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=32,
                               max_blocks_per_seq=6, num_slots=2,
                               max_prefill_len=16, prefill_chunk=8)
        sess = Session(eng, "bits")
        ha = sess.submit(prompt_a, max_new_tokens=7)
        if churn:
            hb = sess.submit(prompt_b, max_new_tokens=2)
        rows = []
        while not ha.done:
            eng.step()
            if churn and hb.done and len(sess.handles) == 2:
                sess.submit(prompt_c, max_new_tokens=3)   # reuse b's slot
            rows.append(eng.last_logits[0].numpy().copy())
        return ha.tokens, np.stack(rows[:6])

    toks_solo, logits_solo = run(churn=False)
    toks_churn, logits_churn = run(churn=True)
    assert toks_solo == toks_churn
    assert logits_solo.tobytes() == logits_churn.tobytes()


def test_backpressure_queued_not_dropped(gqa):
    cfg, params, _ = gqa
    dense = ServeEngine(cfg, params, max_len=16)
    rng = np.random.default_rng(2)
    eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=6,
                           max_blocks_per_seq=3, num_slots=3,
                           max_prefill_len=8, prefill_chunk=8)
    sess = Session(eng, "bp")
    prompts = [rng.integers(0, cfg.vocab_size, (5,)) for _ in range(5)]
    hs = [sess.submit(p, max_new_tokens=4) for p in prompts]
    eng.step()
    mid = eng.stats()
    assert mid["pending"] > 0 and mid["running"] == 2
    eng.run()
    for h, p in zip(hs, prompts):
        assert h.tokens == _dense_solo(dense, p, 4)


def test_cancellation_returns_blocks(gqa):
    cfg, params, _ = gqa
    rng = np.random.default_rng(3)
    eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=16,
                           max_blocks_per_seq=4, num_slots=2,
                           max_prefill_len=8, prefill_chunk=8)
    sess = Session(eng, "cx")
    h1, h2, hq = (sess.submit(rng.integers(0, cfg.vocab_size, (6,)),
                              max_new_tokens=10) for _ in range(3))
    eng.step()
    assert eng.cache.allocator.used_blocks == 8 and len(eng.sched.pending) == 1
    hq.cancel()                                # queued: dropped, no blocks
    h1.cancel()                                # running: blocks come back
    eng.step()
    assert hq.finish_reason == "cancelled" and hq.tokens == []
    assert h1.finish_reason == "cancelled"
    assert eng.cache.allocator.used_blocks == 4
    eng.run()
    assert h2.finish_reason == "length" and len(h2.tokens) == 10


def test_per_request_eos_and_sampling_lanes(gqa):
    """eos is per sequence; a sampled stream is the same whatever its slot
    and neighbours; top_k = 1 is greedy."""
    cfg, params, _ = gqa
    dense = ServeEngine(cfg, params, max_len=16)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (7,))
    eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=32,
                           max_blocks_per_seq=5, num_slots=3,
                           max_prefill_len=8, prefill_chunk=8)
    sess = Session(eng, "mix")
    greedy = _dense_solo(dense, prompt, 6)
    eos = greedy[2]
    stop = greedy.index(eos) + 1
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=11)
    h_eos = sess.submit(prompt, max_new_tokens=6, eos_id=eos)
    h_smp = sess.submit(prompt, max_new_tokens=6, sampling=sp)
    h_grd = sess.submit(prompt, max_new_tokens=6)
    eng.run()
    assert h_eos.tokens == greedy[:stop] and h_eos.finish_reason == "eos"
    assert h_grd.tokens == greedy
    assert len(h_smp.tokens) == 6
    # alone, in another slot: the same sampled stream
    h_again = sess.submit(prompt, max_new_tokens=6, sampling=sp)
    eng.run()
    assert h_again.tokens == h_smp.tokens
    h_k1 = sess.submit(prompt, max_new_tokens=6, sampling=SamplingParams(
        temperature=0.7, top_k=1, seed=3))
    eng.run()
    assert h_k1.tokens == greedy
    assert _dense_solo(dense, prompt, 6, eos_id=eos)[:stop] == greedy[:stop]


def test_sample_tokens_rows_are_independent():
    """A row's draw depends on its own logits, parameters and (seed,
    position) key only; greedy rows are the argmax."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    keys = fold_keys([7, 7, 9, 1], [3, 4, 3, 0])
    temp, top_k, top_p = [0.8, 0.8, 1.2, 0.0], [0, 10, 5, 0], [0.9, 1, 1, 1]
    tok = sample_tokens(logits, keys, temp, top_k, top_p)
    assert tok[3] == torch.argmax(logits[3])
    for r in range(3):
        other = logits.clone()
        other[[i for i in range(4) if i != r]] = torch.from_numpy(
            rng.standard_normal((3, 50)).astype(np.float32))
        again = sample_tokens(other, keys, temp, top_k, top_p)
        assert again[r] == tok[r]
        alone = sample_tokens(logits[r:r + 1], keys[r:r + 1], temp[r:r + 1],
                              top_k[r:r + 1], top_p[r:r + 1])
        assert alone[0] == tok[r]
    assert len(set(fold_keys([7] * 5, range(5)).tolist())) == 5


def test_streaming_and_callbacks(gqa):
    cfg, params, _ = gqa
    dense = ServeEngine(cfg, params, max_len=16)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (6,))
    eng = PagedServeEngine(cfg, params, block_size=4, num_blocks=16,
                           max_blocks_per_seq=4, num_slots=2,
                           max_prefill_len=8, prefill_chunk=8)
    seen = []
    h = Session(eng, "st").submit(prompt, max_new_tokens=5,
                                  on_token=lambda req, t: seen.append(t))
    assert list(h.stream()) == _dense_solo(dense, prompt, 5) == seen \
        == h.tokens


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--engine", "paged"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "(streamed)" in out.stdout and "cancelled after" in out.stdout
    assert "0/32 blocks used after drain" in out.stdout
    res = serve_cli.run(serve_cli.build(
        ["--smoke", "--device", "cpu", "--engine", "dense", "--batch", "2",
         "--new-tokens", "4"]))
    assert len(res["tokens"]) == 2 and len(res["tokens"][0]) == 4


def test_serve_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.run(serve_cli.build(["--smoke", "--engine", "paged"]))
