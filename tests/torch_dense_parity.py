"""Checks shared by the parity tests of the dense GQA configurations
(``test_torch_qwen25.py``, ``test_torch_phi3.py``, ``test_torch_command_r.py``):
the port against the JAX package on the same numpy-seeded inputs.

Each model runs at two smoke sizes: its module's ``SMOKE`` (d=128, 4 q
heads of 32, one layer, fp32) and a shape-faithful one through
``cfg.reduced(...)`` overrides that keeps the real GQA geometry (group 5,
group 12, head dim 96). Both keep the real ``rope_theta``, so the inputs
run to positions past 64, where the tables of theta 1e4 and 1e6 / 7.5e7
part. Parameters are drawn by numpy into the tree of JAX's
``init_params`` (its leaves, shapes and dtypes by ``jax.eval_shape``; the
init's scales: N(0, 1/d_in) matrices, N(0, 0.02^2) embeddings, zero norm
scales) and carried over by ``convert.params_from_jax``; the qkv bias is
drawn too (the reference initialises it to zero, which would test
nothing).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as JT
from repro.serve import PagedServeEngine as JaxPagedServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import Session as JaxSession
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as TT
from repro_torch.serve import PagedServeEngine, ServeEngine, Session

#: fp32 end to end, sums in other orders
TOL = dict(rtol=1e-4, atol=1e-5)
#: tokens of the forward and prefill comparisons (positions 0-79)
SEQ = 80
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def pair(jax_cfg, bias_std: float = 0.5, seed: int = 0):
    """JAX parameters of ``jax_cfg`` drawn by numpy (qkv biases from N(0,
    bias_std)) and the port's copy of them."""
    rng = np.random.default_rng(seed)

    def draw(kp, x):
        path = _path(kp)
        if "norm" in path or "ln" in path:
            value = np.zeros(x.shape, np.float32)
        elif path.endswith("bias"):
            value = rng.normal(0.0, bias_std, x.shape)
        elif "embed" in path:
            value = rng.normal(0.0, 0.02, x.shape)
        else:
            value = rng.normal(0.0, x.shape[-2] ** -0.5, x.shape)
        return jnp.asarray(value.astype(np.float32)).astype(x.dtype)

    jparams = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        lambda: JT.init_params(jax_cfg, jax.random.PRNGKey(seed))))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                            device="cpu")


def configs_match(arch: str, jax_module) -> None:
    """The port's registry entries equal the JAX module's, field by field."""
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_module.CONFIG)
    assert dataclasses.asdict(get_config(arch, smoke=True)) == \
        dataclasses.asdict(jax_module.SMOKE)


def full_config_matches_eval_shape(arch: str, jax_module) -> int:
    """The full configuration's leaves on ``device="meta"`` against
    ``jax.eval_shape`` of JAX's ``init_params``: paths, shapes, dtypes and
    ``param_count``. Returns the count."""
    jtree = jax.eval_shape(lambda: JT.init_params(
        jax_module.CONFIG, jax.random.PRNGKey(0)))
    want = {_path(kp): (tuple(x.shape), str(x.dtype))
            for kp, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    own = TT.init_params(get_config(arch), 0, "meta")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in own.items()}
    assert got == want
    n = TT.param_count(own)
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    assert all(v.device.type == "meta" for v in own.values())
    return n


def smoke_leaves_match(jparams, tcfg) -> None:
    """The port's own ``init_params`` at smoke size: JAX's leaves, shapes
    and dtypes."""
    own = TT.init_params(tcfg, seed=0, device="cpu")
    want = {_path(kp): (tuple(x.shape), _DTYPES[str(x.dtype)])
            for kp, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == want


def logits(jparams, tparams, jcfg, tcfg, *, seed: int = 0, s: int = SEQ):
    """Forward logits of both packages on the same tokens, as fp32 numpy
    (JAX's, port's)."""
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, s))
    jl, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                       jcfg)
    tl, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tl.dtype == _DTYPES[str(jl.dtype)]
    return (np.asarray(jl.astype(jnp.float32)),
            tl.detach().float().numpy())


def dense_stream(jparams, tparams, jcfg, tcfg, *, prompt: int = 70,
                 new: int = 10) -> None:
    """Greedy ``ServeEngine.generate`` equal to JAX's token for token."""
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, prompt))
    want = JaxServeEngine(jcfg, jparams, max_len=prompt + new).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)}, max_new_tokens=new)
    got = ServeEngine(tcfg, tparams, max_len=prompt + new).generate(
        {"tokens": torch.from_numpy(toks)}, max_new_tokens=new)
    assert got.tolist() == np.asarray(want).tolist()


#: the paged engines' settings: prompts past position 64, two slots, the
#: later requests admitted mid-flight
PAGED = dict(block_size=16, num_blocks=24, max_blocks_per_seq=6, num_slots=2,
             max_prefill_len=80, prefill_chunk=32, num_splits=2)


def _churn(eng, session_cls, prompts, budgets):
    sess = session_cls(eng, "churn")
    hs = [sess.submit(prompts[0], max_new_tokens=budgets[0]),
          sess.submit(prompts[1], max_new_tokens=budgets[1])]
    eng.step()
    eng.step()
    hs += [sess.submit(p, max_new_tokens=n)
           for p, n in zip(prompts[2:], budgets[2:])]
    eng.run()
    return hs


def paged_streams(jparams, tparams, jcfg, tcfg) -> None:
    """Greedy streams of ``PagedServeEngine`` under churn equal to JAX's
    token for token; the pool drains."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)) for n in (70, 9, 75, 66)]
    budgets = [12, 3, 10, 6]
    jhs = _churn(JaxPagedServeEngine(jcfg, jparams, **PAGED), JaxSession,
                 prompts, budgets)
    eng = PagedServeEngine(tcfg, tparams, **PAGED)
    ths = _churn(eng, Session, prompts, budgets)
    for jh, th in zip(jhs, ths):
        assert th.tokens == jh.tokens, th.request.request_id
        assert th.finish_reason == jh.finish_reason == "length"
    s = eng.stats()
    assert s["running"] == 0 and s["free_blocks"] == PAGED["num_blocks"]


def paged_chunks_and_decode(jparams, tparams, jcfg, tcfg, tol=TOL) -> None:
    """One 75-token prompt chunk-prefilled in chunks of 48, then two
    ``decode_step_paged`` steps (2 splits): logits at ``tol``."""
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, 75)
    padded = np.zeros((1, 96), np.int32)
    padded[0, :75] = prompt
    jscr = JT.init_prefill_scratch(jcfg, 96)
    tscr = TT.init_prefill_scratch(tcfg, 96, device="cpu")
    jchunk = jax.jit(lambda p, scr, toks, start, take: JT.prefill_chunk(
        p, scr, toks, start, take, jcfg))
    for start in (0, 48):
        take = min(74 - start, 47)
        jl, jscr = jchunk(jparams, jscr, jnp.asarray(
            padded[:, start:start + 48]), jnp.int32(start), jnp.int32(take))
        tl, tscr = TT.prefill_chunk(tparams, tscr, torch.from_numpy(
            padded[:, start:start + 48]).long(), start, take, tcfg)
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(
            jl.astype(jnp.float32)), **tol)
    table = np.array([[2, 5, 1, 7, 0, 0]], np.int32)
    jpools = JT.write_prefill_to_pools(JT.init_paged_pools(jcfg, 8, 16),
                                       jscr, jnp.asarray(table[0]), 75, 16)
    tpools = convert.pools_from_jax(jax.tree.map(np.asarray, jpools),
                                    device="cpu")
    token = np.argmax(np.asarray(jl.astype(jnp.float32)), -1).astype(np.int32)
    pos, active = np.array([75], np.int32), np.array([True])
    jdecode = jax.jit(lambda p, pools, token, pos: JT.decode_step_paged(
        p, pools, token, pos, jnp.asarray(table), jnp.asarray(active), jcfg,
        num_splits=2))
    for _ in range(2):
        jlogits, jpools = jdecode(jparams, jpools, jnp.asarray(token),
                                  jnp.asarray(pos))
        tlogits, tpools = TT.decode_step_paged(
            tparams, tpools, token, pos, torch.from_numpy(table), active,
            tcfg, num_splits=2)
        want = np.asarray(jlogits.astype(jnp.float32))
        np.testing.assert_allclose(tlogits.float().numpy(), want, **tol)
        token = np.argmax(want, axis=-1).astype(np.int32)
        pos = pos + 1


def cli_runs(arch: str, engine: str) -> None:
    """The serving CLI (``engine`` dense or paged) and, with ``engine ==
    "train"``, the training CLI for two steps, ``--smoke --device cpu``."""
    if engine == "train":
        from repro_torch.launch import train as train_cli
        assert train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--steps", "2", "--batch", "2", "--seq-len",
                               "16", "--log-every", "1"]) == 0
        return
    from repro_torch.launch import serve as serve_cli
    res = serve_cli.run(serve_cli.build(
        ["--arch", arch, "--smoke", "--device", "cpu", "--engine", engine,
         "--batch", "2", "--prompt-len", "12", "--new-tokens", "4"]))
    if engine == "dense":
        assert len(res["tokens"]) == 2 and len(res["tokens"][0]) == 4
    else:
        assert res["stats"]["used_blocks"] == 0
